"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py [--against [NAME=]CSRC_DIR ...]
                          [--steps [NAME=]CSRC_DIR ...]
    python3 chip_smoke.py --lfn-profile

``--lfn-profile`` runs only phases 1-2's build and phase 4's bound-0
LiteFlowNet Engine: its host syncs, ATen ops and profile a frame
(``lfn_profile_only``). It needs nothing that the package lacked before
kernels B16 and B17, so a copy of this script in another tree's checkout
(the parent's, from ``git archive`` under ``_local/``) profiles that tree.

Phases, in order; any failure exits non-zero:

1. device: require CUDA and print the card's name and power limit; then
   the libav shim's line, ``libav: loaded <path>`` or ``libav: absent:
   <the loader's error>`` (``native/libtransflow_av.so`` needs the FFmpeg
   shared libraries);
2. build: compile the CUDA kernels of ``transflow_tpu_torch/csrc`` (into the
   git-ignored ``transflow_tpu_torch/_build``); prints each kernel
   instantiation's registers, shared memory and spills as ptxas reported
   them, and fails unless ptxas reported the correlation kernel,
   Farneback's B1, B2a and B2b, B5's two kernels, B9-B12 and the
   pyramids' kernels (B8, B14) free of spills;
F. farneback engine: ``Engine`` at 1080x1920 over a gray frame source with
   ``CvFlowConfig()`` (Farneback with cv2's defaults, the headline
   command's estimator), one moveref layer with random reset 0.01 over
   frames panned 3 px per frame: a warm-up chunk, a timed chunk of 8
   frames and ``process_frame`` calls, counting 4 B1 (one per level, both
   images), 12 B2a, 12 B2b and 1 B8 (every level below L0 of both
   images) launches per frame, the interior median flow of every frame
   within 0.5 px of the pan; then the same Engine with ``assets/configs/
   fast.json``, ``fastest.json`` and ``fb_select_warp=16``, and with
   ``CvFlowConfig()`` once more (the first run of a process reads slower);
P. pipeline: the port's CLI disk to disk in a temporary directory over 24
   P5 frames at 1080x1920 panned as in phase F. P1: ``cli.main`` with
   the headline command's defaults, ``-p noise -r random 0.01 --seed 0
   -o out/%04d.ppm -F -C``: 23 frames that decode to 1080x1920x3, 4 B1
   + 12 B2a + 12 B2b + 1 B8 launches per frame, every exported flow's interior
   median within 0.5 px of the pan, the Engine's state on the card; the
   same cut to 12 frames (``-t 00:00:00.480``), whose frames must be
   P1's first and whose host syncs against P1's give the syncs a frame
   adds. P2: ``--batch-frames 1``, frames and ``-F`` bit-equal to P1's.
   P3: ``--checkpoint-every 12``, frames bit-equal to P1's, then the
   checkpoint at 12 resumed: its frames bit-equal to P1's (a ``-t`` cut
   stores its duration in the checkpoint's config, so its resume renders
   nothing, as in the JAX package). P4: the replay of P1's ``.flow.zip``
   with the same pixmap and seed, frames bit-equal to P1's, no Farneback
   launch. P5: one ``python3 -m transflow_tpu_torch`` process over the
   first 4 frames with a 24-frame ``pix/%04d.ppm`` pixmap sequence,
   flows bit-equal to P1's first. Before P5 the tools over P's outputs
   (``p_tools``): ``viewflow --stats`` over P1's ``-F`` archive (its
   means and maxima numpy's), the render mode over it (23 frames),
   ``ControlSession`` over P1's end checkpoint (a 1080x1920 mapping, a
   paint shown in ``preview()``) and ``FlowClip.flow(0)`` over the PGM
   frames on the card (bit-equal to Farneback on the pair, 4 B1 + 12
   B2a + 12 B2b + 1 B8 launches). Prints the disk-to-disk frames/s and
   ``StageTimers``' split per frame of P1, P2 and P4, and the bare
   Engine's ms/frame on the same frames;
T. post-processing, merges and layer classes: ``Engine`` at 1080x1920
   over two ``CvFlowConfig()`` sources on gray frames panned +3 and -2
   px per frame (source 1 ``-d forward -f scale=1.5;clip=8``; source 2
   a DSL ``--mask``, a 5x5 dyadic ``--kernel`` and ``-f
   polar=r:a+0.1*t``), ``--merge absmax``, and introduction (``-i`` a
   DSL mask), sum, static and moveref layers with ``--mask-alpha``,
   ``--move-mask-source``, ``--move-mask-destination`` and ``-r random
   0.01 -m`` a fractional mask image: a warm-up chunk, a timed chunk of
   8 frames and ``process_frame`` calls, counting 8 B1, 24 B2a, 24 B2b,
   2 B8 and 2 B5 launches (B5's two kernels, no memset) per frame, finite
   flows, the per-frame checksums read back once, 0 host syncs per frame,
   and its profile (device busy time and idle share per frame); then the
   same
   options through ``cli.main`` over 12 PGM frames of each pan (the CLI
   gives both sources ``-d forward``: 4 B5 a frame); then at 128x192 the
   post-process chain on the card against the CPU within the CPU tests'
   bounds, B5 bit-equal on the same input, and the four-layer compositor
   bit-equal given the same flows;
H. the secondary estimators: ``Engine`` at 1080x1920 over phase F's pan
   with one moveref layer (random reset 0.01) for each Horn-Schunck and
   Lucas-Kanade preset of ``assets/configs`` (``horn-schunck``,
   ``horn-schunck-diverge``, ``horn-schunck-smooth-inertia``,
   ``lukas-kanade``, ``lk16``): a warm-up chunk, a timed chunk of 8
   frames and ``process_frame`` calls, counting 1 B9 and ``hs_iterations``
   B10 launches per frame, or 30 B11, 33 B12 (10 of each per level, and
   B12's structure tensor once per level, at three levels) and 1 B14 (the
   whole pyramid of both frames, their float32 casts included), finite
   flows,
   0 host syncs per frame, and for ``lukas-kanade.json`` every interior
   median within 0.5 px of the pan; then a static pair through
   Horn-Schunck (one iteration taken of 5, read back once after the
   frame), then ``cli.main`` over 4 PGM frames of the pan with ``-c
   horn-schunck.json`` and ``-c lukas-kanade.json``;
V. video, where the libav shim loads: 24 frames at 1080x1920 (phase F's
   texture panned 3 px a frame) encoded by the port's ``H264Writer`` (bf
   0, refs 1), every interior motion-vector field's dominant value the
   pan, the host rasterization timed a frame; then ``cli.main([clip,
   "--mv", "-p", "noise", "--seed", "0", "-o", out.mp4])`` on the card:
   ``out.mp4`` reopens through ``MvReader`` at 1080x1920 with 23 frames,
   and against the same cut to 12 frames 0 host syncs a frame; prints
   the disk-to-disk frames/s and ``StageTimers``' split;
S. streams: ``make_mesh(devices=[card] * 2, stream_axis=2)``, two 1080x1920
   streams (pans of +3 and -3 px, their own random pixmaps) through
   ``sharded_scan(..., per_stream_pixmaps=True)``, the batch renderer's
   model (Horn-Schunck ``max_iters=8, delta=None``, random reset 0.05),
   two chunks of 8: 1 B9 + 8 B10 launches a stream-frame, each stream
   bit-equal to its own ``model.scan`` alone with its key and pixmap,
   ms a stream-frame, 0 host syncs a stream-frame; then stream 2 x space
   2 (``[card] * 4``) with ``halo=8`` and ``clip=8`` against space 1
   (flows within 1e-5, frames bit-equal); then ``tools/batch_render.py``
   over two 9-frame PGM sequences, its ``%04d`` frames equal to the
   first chunk's, and its MP4s reopened where the shim loads; in phase
   10 its profile (busy time and idle share a stream-frame);
M. multi-host: this script again as two worker processes
   (``--multihost-worker RANK PORT``, read only here) joined by gloo on
   127.0.0.1, each giving ``[card] * 2`` to ``make_global_mesh``:
   stream 2 x space 2, a row a process; an all-reduce of a sharded
   tensor's sum; four 1080x1920 streams (pans of +3, -3, +2 and -2 px)
   of phase S's model with ``halo=8`` and ``clip=8`` through
   ``sharded_scan``, two a process, two chunks of 8: 1 B9 + 8 B10 and 0
   host syncs a stream-frame in each process, each stream's frames
   bit-equal (digests gathered with ``all_gather_object``) to its lone
   ``model.scan`` in this process; A2 on each process's row at L3
   (stride 2) bit-equal to A1. Prints ms a stream-frame for each process
   and for both, beside the four streams through one process's
   ``sharded_scan`` (stream 2 x space 2), and each process's busy time
   and idle share a stream-frame (``torch.profiler``). A worker that
   exits non-zero or outlives its time fails the run;
G. live tuning, video input, the MJPEG preview and the GUI. G1, on every
   machine: phase F's ``CvFlowConfig()`` Engine at 1080x1920 on the 3 px
   pan, 4 frames through ``process_frame``, then
   ``CvFlowConfigWindow(config).apply_value("fb_iterations", "5")`` with
   no window opened, then 4 frames more: one estimator rebuild (on the
   first frame after the change), B1/B2a/B2b/B8 launches a frame
   4/12/12/1 then 4/20/20/1, 0 host syncs a frame after the rebuild frame, the
   rebuild frame's raw flow bit-equal to ``farneback`` with the new
   ``estimator_kwargs()`` on the same pair and warm start; ms/frame
   before, on and after the rebuild frame. G2, where cv2 and aiohttp
   load: 24 frames of phase F's pan written by ``cv2.VideoWriter`` (MJPG
   in an .avi); ``CvFlowSource``'s gray frames bit-equal to
   ``cv2.VideoCapture``'s own; ``cli.main([clip, "-p", "noise",
   "--seed", "0", "-o", out/%04d.ppm])`` on the card (23 frames,
   4/12/12/1 launches and, against a 12-frame cut, 0 host syncs a frame); ``-o
   mjpeg:PORT`` with one multipart frame fetched over HTTP that decodes
   to 1080x1920; the headline ``clip.avi -p still.png -o out.mp4``
   (the encoder chain's first writer that opens; 23 frames reopened by
   cv2). G3, where websockets loads too: ``GuiServer`` on free ports
   rendering on the card, one ``GENERATE`` of G2's command over a
   9-frame cut: ``STATUS``, then ``DONE`` with the output's path, 9
   frames. Where a library is missing the route prints ``G2: absent:
   <the import error>`` (or ``G3: ...``) and the run goes on; a route
   whose libraries load and then fails fails the run;
K. the bench: ``transflow_tpu_torch/bench.py``'s ``main(["--e2e"])`` in
   this process, cut to 4 chunks of 16 frames a sample, 3 samples and a
   24-frame clip: the flagship's frames/s (Farneback at cv2's defaults,
   random reset 0.01, 1080x1920), its stage split, LiteFlowNet at
   1088x1920, the ``fastest`` preset and the CLI disk to disk over a cv2
   MJPG clip (still pixmap, video pixmap, ``.flow.zip`` replay), the
   record printed as its own JSON line; it must hold every field, B1/B2a/
   B2b/B8 launches of 4/12/12/1 and A1/A3/B7/B16/B17/B18 of 5/0/14/6/5/93 a
   frame, 0
   host syncs a frame and this card's name and power limit; then 3 cases of
   the chunk
   fuzzer (``tools/fuzz_chunks.py``, seed 5) on the card at 96x128, each
   chunked render bit-equal to the per-frame one and each resumed tail
   to the run;
3. slice: ``FlowTransferModel(1080, 1920, method="liteflownet")`` with random
   weights and one moveref layer over panned synthetic frames, counting
   the correlation kernel's launches (5 a frame), the exact backwarp's
   (B7, 14 a frame), the phase upsampler's (B16, 6), the
   regularization's tap apply's (B17, 5) and the convolution epilogue's
   (B18, 93: one a convolution);
4. engine: ``Engine`` at 1080x1920 over a frame source with
   ``CvFlowConfig(method="liteflownet", lfn_warp_bound=16)``, one moveref
   layer with random reset 0.01: a warm-up chunk, a timed chunk of 8
   frames, then ``process_frame`` calls, counting 9 A3, 5 B7 (the
   regularization's 3-channel warps), 5 correlation, 6 B16, 5 B17 and 93
   B18 launches per frame and 0 host syncs per frame; then the same Engine
   with ``lfn_warp_bound=0`` (every warp exact: 14 B7) on the same
   frames;
5. mesh engine: the bound-16 Engine under ``make_space_mesh(4)`` over
   four shards of the card with ``halo=8``: the bound is stripped, and
   each frame launches 4 A2 kernels (levels 2-5, one per level), 1 A1
   (level 6), no A3, 14 B7, 6 B16, 5 B17 and 93 B18; its flows and frames
   against
   the bound-0 run of
   phase 4; then the mesh and meshless Engines in turns (eight ABBA rounds
   of 3-frame ``process_frame`` windows) for the mesh's cost per frame;
6. kernel vs plain: the correlation kernel against its plain PyTorch
   version at the five shapes LiteFlowNet gives it on a 1088x1920 frame,
   in each dtype pair, with its ``device_ms``, its bound and its share of
   the bound (below);
7. bounded backwarp vs plain: kernel A3 at the five shapes the bounded
   path gives it on a 1088x1920 frame (base bound 16), bf16 and f32
   images, flows within the bound and with a fifth of the pixels beyond;
   within the bound also ``F.grid_sample`` on the same image (rounded to
   bf16, as A3 reads it) and flow, the library call that computes the
   same function there, held to A3 and timed only here as a yardstick;
   then the exact backwarp B7 (``exact_backwarp``) at the 9 feature
   warps' shapes of a bound-0 frame (5 shapes, bf16 and f32) and its 5
   regularization warps (the 3-channel half of an f32 6-channel pair,
   read in place), bit-equal to its plain version on flows of 8 px at L2
   scaled to the level whose taps stay in the frame (where it is timed)
   and on the same with a fifth of the pixels 1-3 frames outside; beside
   it ``F.grid_sample`` on the first (where it is B7's function), held
   to B7 within ``grid_sample_tol`` and timed as the yardstick;
7b. LiteFlowNet's heads vs plain: B16 (``upsample2x_phases``) at its six
   shapes of a 1088x1920 frame (the flow at L6-L3 and the cost volume at
   L3 and L2, each doubled) in float32 (the path's) and bfloat16, beside
   ``F.conv_transpose2d`` on the same input (TF32 off), held to B16
   within ``UP_LIBRARY_EPS`` epsilons and timed as the yardstick; B17
   (``reg_apply``) at its five levels (S 3, 5, 7) with bf16 (the path's)
   and f32 distances, the flow in the path's dtype, then NaN distances;
   each bit-equal to its plain version on random inputs, with
   ``device_ms``, the bound, the share, ``call_ms``, the plain version's
   time and ATen ops (no single PyTorch call computes B17);
7c. the convolution epilogue vs plain: B18 (``conv_epilogue``) on the 93
   calls of one bound-0 1088x1920 forward (their shapes held to
   ``B18_FRAME``, the layouts cuDNN returned printed), then at each of
   ``B18_FRAME``'s 32 (N, H, W, C) in bf16 (and f32 at L2) from
   channels_last and contiguous NCHW inputs, with and without the leaky
   ReLU, bit-equal to its plain version; the path's row of each (bf16, its
   layout and leaky ReLU) with ``device_ms`` (in place), the bound, the
   share, ``call_ms``, the plain version's time and ATen ops, and the ops
   it replaced (``b18_replaced``: the bias cast, the add on the permuted
   view, ``F.leaky_relu``) timed on the same input;
8. sharded correlation: kernel A2 (``sharded_correlation7x7``, one launch
   per card that reads each shard's halo rows in place) at the five
   correlation shapes in the slice's dtype pairs, over 4 and 2 shards that
   repeat the card (a level whose H does not shard is skipped, as the
   Engine skips it), bit-equal to A1 and within 1e-5 of plain; beside
   it the same launch from the views' descriptors of the cross-card path
   (``a2_views``, bit-equal to A1 too), timed for what the one-card
   descriptors save the host; over distinct cards too where the machine
   has more than one;
B. farneback kernels vs plain: B1 (``poly_expansion_pair``, both images
   of a level in one launch), B2a (``update_equations``, select radius 0
   and 16, on a random flow and on the Engine's pan scaled to the level)
   and B2b (``aggregate_solve``, box and Gaussian) at the four level
   shapes of a 1080p frame in bf16 and float32 storage, on B1's own
   planes, each bit-equal to its plain version; then B8
   (``pyramid_levels``, both images and every level in one launch) on a
   1080p frame in bf16 and float32: the pyramid of cv2's defaults (its
   bound over all three levels), then each level alone (the three are
   also ``fb_downscale`` 2, 4 and 8's pre-resize), ``fb_pyr_scale`` 0.8's
   first level and ``fb_levels`` 8's deepest (radius 95, the deep route),
   bit-equal to its plain version, beside the path it replaced (two
   cuDNN passes and ``F.interpolate(antialias=True)`` an image and level,
   ``b8_replaced``) timed on the same images;
9. equivalence: at 128x192 in float32 (TF32 off) the CUDA slice against
   the CPU slice, Farneback on both devices, Horn-Schunck (bit-equal) and
   Lucas-Kanade (within 1e-4) on both devices, the compositor on both
   devices on one flow, and the 1080x1920 threefry draw of the random
   reset on both devices;
10. kernel time: ``torch.profiler``'s kernel durations of A1 (the slice's
   dtype pairs), A2 (every sharded case), A3 beside ``F.grid_sample`` at
   L2-L6 (phase 7's bf16 inputs within the bound), B7 beside
   ``F.grid_sample`` at every phase 7 row (its time a level and a bound-0
   frame, 9 bf16 feature warps and 5 image warps), B16 beside
   ``F.conv_transpose2d`` and B17 at every phase 7b row, B18 beside every
   device event of the ops it replaced at every phase 7c path row (a
   frame's 93 launches summed), B1, B2a, B2b, B8
   at the four levels and B9-B12, B14 at theirs, B8 and B14 beside every
   device event of the path each replaced; then the Farneback Engine's
   (which must show no cuDNN kernel and none of ``F_REPLACED_OPS``),
   phase 4's bound-0 LiteFlowNet Engine's (with its ATen ops a frame,
   each of its hand-written kernels' device time a frame, ``lfn_profile``,
   and ``epilogue_audit``: no bias add, no parameter cast and only the
   correlation's 5 float32 leaky ReLUs a frame, else the run fails),
   each phase H Engine's and phase S's device events, busy time and idle
   share per frame over a few ``process_frame`` (or one-frame
   ``sharded_scan``) calls, and their device time per frame by kernel
   name (the ``PROFILE_TOP`` largest) and that of the compositor's K0,
   K1 and K2;
11. with ``--against [NAME=]CSRC_DIR`` only (repeatable): the correlation
   kernel, B1, B2a, B2b, B9, B10, B5, B8, B14, B16 and B17 against other
   trees' ``correlation.cu``, ``farneback.cu``, ``horn_schunck.cu``,
   ``scatter.cu``, ``pyramid.cu`` and ``lfn_heads.cu`` (for example the
   parent commit's, from ``git archive`` under the git-ignored ``_local/``),
   built with the package's flags, all through the raw C entries,
   ``device_ms`` in turns (others, this, this, others): the correlation at
   its five level shapes; B1 (both images of a level:
   ``transflow_poly_expansion_pair`` where the other tree has it, else two
   ``transflow_poly_expansion`` calls), B2a (select radius 0, on a random
   flow and on the pan) and B2b (the box) at the four 1080p level shapes
   in bf16; then B2a on the inputs of each of its 12 launches in a frame
   of phase F's ``CvFlowConfig()`` Engine; then B9 on the pan's 1080p
   frames and B10's three launches under delta 1 from a zero flow
   (``horn-schunck.json``'s frame), where the other tree has
   ``horn_schunck.cu``; then B5 on phase B5's four inputs, where the
   other tree has ``scatter.cu``, ``device_ms`` in turns and the
   profiler's time of every device event of a call, each tree with its
   own zeroed scratch; then B8 (``against_pyramid``) on a 1080p bf16 pair
   as the pyramid of cv2's defaults, each of its levels and fb_levels 8's
   deepest: ``transflow_pyramid_levels``, or in an older tree a
   ``transflow_pyramid_level`` call a level; then B14
   (``against_lk_pyramid``) on the pan's 1080p uint8 pair as
   ``lukas-kanade.json``'s pyramid (``transflow_lk_pyramid`` once, or in
   an older tree ATen's two casts and a ``transflow_pyramid_reduce`` call
   a level) and each reduce alone; last, where the other tree has
   ``lfn_heads.cu``, B16 and B17 (``against_lfn_heads``) at B16's six
   shapes of a 1088x1920 frame in float32 and B17's five levels with bf16
   distances (a bf16 flow at L6), ``device_ms`` in turns, each tree's
   profiler kernel time of a call, and their sums over a frame's 6 and 5
   launches; where the other tree has ``conv_epilogue.cu``, B18
   (``against_conv_epilogue``) at every ``B18_FRAME`` entry in bf16 from a
   channels_last input into each tree's own output, and its sum over a
   frame's 93 launches; bit-equal between the trees (B10's
   flows and its control words ``[stop, iterations]`` too, B5's
   mappings, B8's, B14's, B16's and B17's outputs).
   ``--steps [NAME=]CSRC_DIR`` (repeatable, with or without
   ``--against``) adds to B8's and B14's, or B16's and B17's, turns (each
   where it has the entry) a directory's ``pyramid.cu`` or
   ``lfn_heads.cu``, a copy of a tree's cut to some of its steps, whose
   outputs are not held to the others'.

B5. after phase B: kernel B5 (``forward_to_backward``) against its plain
   version at 1080x1920 on a random forward flow, a converging one (every
   pixel onto the centre: one word takes every write), phase T's
   Farneback forward flow on the pan and a constant (W/2, 0) whose right
   half of each row clips onto the row's last pixel (``-f`` scaling a pan
   past the edge), bit-equal, with ``device_ms``, the bound and its
   share, and in phase 10 the profiler's time of a call (every device
   event of it: both kernels).
B9. after B5: kernels B9 (``hs_derivatives``) and B10 (``hs_iterate``,
   three steps under delta 1, then timed under delta 0 so every launch
   steps and runs the reduction every preset runs; beside it one
   copy-through launch, the stop word set) at 1080x1920 on the pan's
   frames, with B10's count of partial sums read back from the kernel
   library, B11 (``lk_warp_products``)
   and B12 (``lk_structure_tensor`` and ``lk_window_solve``, window 15)
   at the three levels of Lucas-Kanade's 1080p pyramid on the pan's
   images, Scharr derivatives and flow, and B14 (``lk_pyramid``) making
   that pyramid from the pan's uint8 pair in one launch (the main row,
   beside the path it replaced, ``b14_replaced``: the frames' casts and a
   reduce a level), then each level below L0 alone from one image of the
   level above (``downsample2x``), each bit-equal to its plain version on
   the same inputs, with ``device_ms``, the bound, its share and the
   plain version's time.
C. after phase 9: the compositor's kernels (``ops/compositor.py``,
   ``csrc/compositor.cu``) against their plain versions at 1080x1920,
   bit-equal: K1 (``layer_update``) on phase F's Engine state, its
   pixmap and its last pan flow (the moveref layer with random reset
   0.01), on a random flow, and with leave-empty (K0 then K1); K0
   (``leave_empty_sources``) alone; K2 (``composite``) over phase F's
   layer and over phase T's four masked layers; each with ``device_ms``,
   the bound (``comp_k1_bound_ms`` etc.: the bytes these inputs need),
   its share, ``call_ms``, the plain version's time and its ATen ops, and
   in phase 10 its kernel time.

Every Engine, CLI and bench run of the main path counts the compositor's
launches beside the estimators' (``KERNEL_NAMES``: K0, K1, K2, then the
pyramids' B8 and B14, then LiteFlowNet's exact backwarp B7 and its heads'
B16 and B17, 6 and 5 a LiteFlowNet frame, and its convolution epilogue
B18, 93, ``LFN_HEADS``): one moveref
layer updates through one K1 and renders through one K2 a frame
(``C_MOVEREF``), phase T's four layers take 1 K0, 2 K1 and 1 K2; under a
mesh that splits the movement (phases 5 and M) the moveref layer updates
through its plain ops and renders through K2 (``C_MESH``).

The main path (phases F, P, T, H, V, S, M, G, K and 3-5) runs right after
the build:
the kernel phases' timing loops, plain versions and profiler come after
every timed run of it, so they cannot reach those timings.

Timings. ``device_ms`` is CUDA events around N back-to-back calls, over
N: the card's time per call where the host keeps ahead of it, else the
host's issue rate; ``torch.profiler``'s summed kernel durations tell the
two apart at the correlation's levels (``kernel_ms``, phase 10).
``call_ms`` is the median of single calls between two events, host time
included. The bound (``bound_ms``) is the least time the card could take
for the work: the larger of the bytes moved (each input byte read once,
on the even grid at stride 2, each output byte written once) over 3.35
TB/s and the operations over 67 TFLOP/s (f32 outside the tensor cores),
the H100 SXM's published peaks; ``share`` is bound over ``device_ms``.

For B1, B2a and B2b the bound counts each input and output byte once per
level and the float32 operations of their correlations, lerps and
algebra; B8's and B14's each image read once and each level written
once (B14's pyramid: both uint8 frames read, their float32 copies and
two levels written), and the operations of the blurs and the resize's
bands in the order that needs fewest (``pyramid_bound_ms``); B5's counts
the flow read and the mapping written once (16 bytes a pixel); B9-B12's
each input and output plane once a launch
(``hs_bound_ms``, ``lk_bound_ms``); K0-K2's the bytes that their
outputs need on these inputs, pixel by pixel (``comp_k*_bound_ms``;
K1's draw's integer operations counted at the f32 rate). They are
hand-written for jnp code (no Pallas source) and no single PyTorch call
computes any of them (``index_put_`` with duplicate indices writes in
no fixed order on CUDA; no single call blurs and resizes).

B16's bound counts the input, the taps and the output once and 7
operations an output value; B17's the distances, the flow and the output
once and 11 operations a tap (the exponential as one), 5 a pixel
(``up_bound_ms``, ``reg_bound_ms``); B18's cuDNN's output read and the
result written once and 1 operation an element, 3 with the leaky ReLU
(``epilogue_bound_ms``).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Imports no JAX.
"""
import argparse
import ctypes
import functools
import hashlib
import itertools
import json
import os
import re
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# one moveref layer's K0, K1, K2 launches a frame (random reset, no
# leave-empty): the rule the bench holds the flagship to
from transflow_tpu_torch.ops.compositor import \
    MOVEREF_PER_FRAME as C_MOVEREF

SEED = 0
HEIGHT, WIDTH = 1080, 1920
# (H, W, C, stride, name) of the correlation at each LiteFlowNet level of a
# 1088x1920 network input (the 1080p frame resized up to a multiple of 32)
CORR_SHAPES = ((34, 60, 192, 1, "L6"), (68, 120, 128, 1, "L5"),
               (136, 240, 96, 1, "L4"), (272, 480, 64, 2, "L3"),
               (544, 960, 64, 2, "L2"))
BF16, F32, U8 = torch.bfloat16, torch.float32, torch.uint8
# the dtype pair the slice gives each level: L6 correlates two bf16
# features, L2-L5 a bf16 feature with an f32 backwarped one
MAIN_PAIR = {"L6": (BF16, BF16), "L5": (BF16, F32), "L4": (BF16, F32),
             "L3": (BF16, F32), "L2": (BF16, F32)}
DTYPE_PAIRS = ((BF16, BF16), (BF16, F32), (F32, F32))
# kernel vs plain: both f32 math, different summation order
CORR_ATOL = CORR_RTOL = 1e-5
# (H, W, C, bound, name) of the bounded backwarp at each level of a
# 1088x1920 network input with lfn_warp_bound=16, and its launches per
# frame there (matching and subpixel; level 6 has no matching warp)
WARP_SHAPES = ((34, 60, 192, 3, "L6"), (68, 120, 128, 3, "L5"),
               (136, 240, 96, 4, "L4"), (272, 480, 64, 8, "L3"),
               (544, 960, 64, 16, "L2"))
WARP_PER_FRAME = {"L6": 1, "L5": 2, "L4": 2, "L3": 2, "L2": 2}
# kernel vs plain: the same bf16 staging and f32 terms in the same order
WARP_ATOL = WARP_RTOL = 1e-5
WARP_BOUND = 16
# the exact backwarp (B7) a frame of a 1088x1920 input: with no bound the
# 9 feature warps (matching at L5-L2, subpixel at L6-L2: WARP_SHAPES'
# shapes, WARP_PER_FRAME times each) and the regularization's 5 warps of
# the 3-channel half of the 6-channel image pair (B7_LEVELS); with a bound
# only the regularization's (3 channels: under 16, never bounded)
B7_EXACT = 14
B7_BOUNDED = 5
B7_LEVELS = ((34, 60, "L6"), (68, 120, "L5"), (136, 240, "L4"),
             (272, 480, "L3"), (544, 960, "L2"))
B7_REACH = 8.0   # px at L2 of the random flows, scaled with the level
B7_FAR = 0.2     # their share of pixels 1-3 frames outside the frame
def b18_frame(h: int, w: int) -> tuple:
    """B18's launches a frame of an H x W network input (multiples of 32)
    at any bound, meshed or not, one a convolution: ((N, H, W, C) of
    cuDNN's output, leaky or not, launches a frame, name). The features'
    convolutions take both images; at each level the matching and subpixel
    heads' main0-main2 (128, 64, 32 channels) and main3 (2, no leaky ReLU),
    the regularization's feat0 (L2-L4) and main0-1 (128), main2-3 (64),
    main4-5 (32) and its distances (dist0, and dist1 at L2-L4; no leaky
    ReLU)."""
    rows = [((2, h, w, 32), True, 1, "features one0")]
    for k, (c, n, name) in enumerate(((32, 3, "two0-two2"),
                                      (64, 2, "thr0-thr1"),
                                      (96, 2, "fou0-fou1"), (128, 1, "fiv0"),
                                      (192, 1, "six0")), 1):
        rows.append(((2, h >> k, w >> k, c), True, n, f"features {name}"))
    rows.append(((2, h >> 1, w >> 1, 64), True, 2, "L2 heads' feat0"))
    for lvl, taps in ((2, 49), (3, 25), (4, 25), (5, 9), (6, 9)):
        lh, lw, feat = h >> (lvl - 1), w >> (lvl - 1), int(lvl < 5)
        rows += [((1, lh, lw, 128), True, 4 + feat, f"L{lvl} 128"),
                 ((1, lh, lw, 64), True, 4, f"L{lvl} 64"),
                 ((1, lh, lw, 32), True, 4, f"L{lvl} 32"),
                 ((1, lh, lw, 2), False, 2, f"L{lvl} main3"),
                 ((1, lh, lw, taps), False, 1 + feat, f"L{lvl} dist")]
    return tuple(rows)


# a 1088x1920 frame's; the network gives it bf16
B18_FRAME = b18_frame(1088, 1920)
B18_PER_FRAME = sum(row[2] for row in B18_FRAME)
# the heads' and epilogue's kernels a LiteFlowNet frame at any bound,
# meshed or not: B16 upsamples the flow at L5-L2 and the cost volume at L3
# and L2, B17 applies the regularization's taps at each of the five
# levels, B18 follows each of the 93 convolutions
LFN_HEADS = {"B16": 6, "B17": 5, "B18": B18_PER_FRAME}
# B16's shapes a 1088x1920 frame, one launch each: (h, w, C, name) of the
# half-res input. The path gives it float32 (the flow after the
# regularization, the correlation's float32 cost volume); the rows are
# held in bfloat16 too
B16_SHAPES = ((34, 60, 2, "flow L6->L5"), (68, 120, 2, "flow L5->L4"),
              (136, 240, 2, "flow L4->L3"), (272, 480, 2, "flow L3->L2"),
              (136, 240, 49, "cost L3"), (272, 480, 49, "cost L2"))
# B17's shapes: (H, W, S, name), one launch a level; the network gives it
# bf16 distances, and at L6 a bf16 flow (the matching and subpixel heads'
# sum of two bf16 convolutions), elsewhere an f32 one
B17_LEVELS = ((34, 60, 3, "L6"), (68, 120, 3, "L5"), (136, 240, 5, "L4"),
              (272, 480, 5, "L3"), (544, 960, 7, "L2"))
# F.conv_transpose2d against B16: each output is the sum of the same four
# products in another order (and cuDNN's own rounding in bf16), so within
# this many units of the dtype's epsilon of 4 * max|x| * max|taps|
UP_LIBRARY_EPS = 4
LFN_SYNC_CALLS = 1     # process_frame calls that count the host's syncs
LFN_PROFILE_CALLS = 3  # process_frame calls under the profiler (phase 10)
# F.grid_sample against A3 within the bound: grid_sample finds each tap
# from a normalised position ((x + u) * 2 / (W - 1) - 1, unnormalised
# again), so its fractions carry a few ulp of the frame's size where A3's
# come from the flow alone; a value moves by at most that error times the
# image's range, per axis
GRID_SAMPLE_ULPS = 4
# the mesh Engine: four shards of one card, a halo of 8 rows (1080 / 4 =
# 270 >= 8, so the sharded movement gather runs); A2 launches per frame
MESH_SHARDS = 4
MESH_HALO = 8
A2_PER_FRAME = 4
# A2 against A1: the same products in the same order
A2_ATOL = 0.0
MESH_FLOW_ATOL = 1e-5
EQUIV_FLOW_ATOL = 1e-3
# Farneback on the card against the CPU: tests/test_torch_farneback.py's
# bar against JAX (PSNR at an 8 px peak)
FB_EQUIV_PSNR = 60.0
# Lucas-Kanade on the card against the CPU: tests/test_torch_lucas_kanade.py's
# bar against JAX
LK_EQUIV_ATOL = 1e-4
SLICE_FRAMES = 8
ENGINE_WARMUP = 2
ENGINE_FRAMES = 8
ENGINE_CALLS = 3
EQUIV_FRAMES = 4
TURN_WINDOW = 3    # process_frame calls per window of the in-turns timing
TURN_ROUNDS = 8    # ABBA rounds of the in-turns timing
# the H100 SXM's published peaks (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
DEVICE_LAUNCHES = 100
PLAIN_LAUNCHES = 3
AGAINST_ROUNDS = 3   # rounds of (others, this, this, others) in phase 11
# the Farneback Engine (phase F): frames panned FB_PAN px per frame along
# both axes, so the backward flow is (FB_PAN, FB_PAN) inside the frame
FB_PAN = 3
FB_PAN_TOL = 0.5
FB_MARGIN = 64        # rows and columns left out of the median check
# B1, B2a, B2b, B8 launches per frame of CvFlowConfig(): 4 levels (both
# images in one launch), 3 iterations x 4 levels, 3 x 4, and one pyramid
# launch for the 3 levels below L0 of both images
FB_DEFAULT_PER_FRAME = (4, 12, 12, 1)
# the Farneback kernels in launches_per_frame's order
FB_NAMES = ("B1", "B2a", "B2b", "B8")
FB_PROFILE_CALLS = 3  # process_frame calls under the profiler (phase 10)
FB_SYNC_CALLS = 1     # process_frame calls that count the host's syncs
# (H, W, name) of the pyramid of a 1080p frame at pyr_scale 0.5, levels 3
FB_LEVELS = ((1080, 1920, "L0"), (540, 960, "L1"), (270, 480, "L2"),
             (135, 240, "L3"))
FB_POLY_N, FB_POLY_SIGMA, FB_WINSIZE, FB_RADIUS = 5, 1.2, 15, 16
# float32 operations per pixel and image. B1: nine correlations of 2n+1 taps (a
# product and a sum each), five 6-term dot products and the halving. B2a:
# the sample of five planes (coordinates, weights, three lerps of three
# operations per plane; the select warp lerps two rows per column tap) and
# the algebra (the averages, b, A'A, A'b, the weight). B2b: per plane a
# vertical and a horizontal correlation of the window's taps, then the
# solve.
B1_OPS = 18 * (2 * FB_POLY_N + 1) + 5 * 11 + 1
B2A_OPS = {0: 53 + 46, FB_RADIUS: 65 + 46}
B2B_OPS = 6 * 4 * FB_WINSIZE + 14
# launches per level and frame of each Farneback kernel (CvFlowConfig())
FB_PER_LEVEL = {"poly_expansion": 1, "update_equations": 3,
                "aggregate_solve": 3}
# B8's levels of a 1080p frame at cv2's defaults (H, W, name, sigma: the
# blur of scale 0.5 ** k), one launch a frame each; then its rows off the
# main path: fb_pyr_scale 0.8's first level (radius 0, sizes no whole
# ratio gives) and fb_levels 8's deepest (scale 1 / 64, radius 95: tiles
# of one output column, whose segment the threads walk in turns)
B8_LEVELS = ((540, 960, "L1", 0.5), (270, 480, "L2", 1.5),
             (135, 240, "L3", 3.5))
B8_OFF_PATH = ((864, 1536, "pyr_scale 0.8 L1", 0.125),
               (17, 30, "levels 8 L6", 31.5))
# B8's rows (name, levels): the main path's pyramid in one launch, then
# each level alone (F's levels are also fb_downscale 2, 4 and 8's
# pre-resize; levels 8 L6 takes the deep route, two launches)
B8_CASES = (("pyramid", B8_LEVELS),
            *((name, ((h, w, name, sigma),))
              for h, w, name, sigma in B8_LEVELS + B8_OFF_PATH))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


def device_ms(fn, launches: int = DEVICE_LAUNCHES, warmup: int = 3
              ) -> float:
    """ms per call of ``fn()`` over ``launches`` back-to-back calls between
    two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def kernel_split(fn, launches: int = DEVICE_LAUNCHES) -> dict[str, float]:
    """The summed durations of each device event name over ``launches``
    calls under ``torch.profiler``, in ms per call. Only device events
    count: the CPU ops that launch a library kernel
    (``aten::grid_sampler_2d``) carry its time too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.events():
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            split[e.name] = (split.get(e.name, 0.0)
                             + e.time_range.elapsed_us() / 1e3 / launches)
    return split


def kernel_ms(fn, pattern: str, launches: int = DEVICE_LAUNCHES
              ) -> float | None:
    """The summed durations of the kernels whose name holds ``pattern``
    per call (``kernel_split``); the profiler misses a window's events now
    and then, so a window with none is profiled once more; None where
    neither saw device time."""
    for _ in range(2):
        total = sum(ms for name, ms in kernel_split(fn, launches).items()
                    if pattern in name)
        if total:
            return total
    return None


def corr_bound_ms(h: int, w: int, c: int, stride: int, t1, t2
                  ) -> tuple[float, str]:
    """The correlation's bound: f1 and f2 on the even grid read once, the
    49-wide f32 output written once, 2 * 49 * C operations per pixel."""
    pixels = -(-h // stride) * -(-w // stride)
    nbytes = pixels * (c * (t1.itemsize + t2.itemsize) + 49 * 4)
    return _bound(nbytes, 2 * 49 * c * pixels)


def warp_bound_ms(h: int, w: int, c: int, dtype) -> tuple[float, str]:
    """The bounded backwarp's bound: the image and the f32 flow read once,
    the f32 output written once, 4 taps of 2 operations per value."""
    nbytes = h * w * (c * dtype.itemsize + 2 * 4 + c * 4)
    return _bound(nbytes, 8 * h * w * c)


def exact_warp_bound_ms(h: int, w: int, c: int, dtype) -> tuple[float, str]:
    """The exact backwarp's bound: the image's C channels and the f32 flow
    read once, the f32 output written once; per value 3 products a tap
    and 3 sums, per pixel the anchor's 18 operations."""
    nbytes = h * w * (c * dtype.itemsize + 2 * 4 + c * 4)
    return _bound(nbytes, h * w * (15 * c + 18))


def _bound(nbytes: float, ops: float) -> tuple[float, str]:
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return (1e3 * max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


def call_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median ms of ``fn()`` over ``reps`` calls, each timed alone between
    two CUDA events: host time included."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    card = card_line()
    print(f"card: {card}")
    return card


def _demangled(names: list[str]) -> list[str]:
    """Kernel names as ``c++filt`` reads them, short of namespaces and
    parameters; the mangled names where it is missing."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, check=True,
                             timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return names
    short = []
    for name in out:
        name = name.replace("(anonymous namespace)::", "")
        name = name.removeprefix("void ")
        short.append(name.split("(")[0].replace("__nv_bfloat16", "bf16"))
    return short if len(short) == len(names) else names


def ptxas_reports(log: str) -> list[dict]:
    """Each kernel instantiation's ptxas report in nvcc's log (``-Xptxas
    -v``): its mangled name, registers, static shared memory (bytes) and
    spill stores and loads (bytes)."""
    reports = []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            reports.append({"kernel": line.split("'")[1], "registers": None,
                            "smem": 0, "spills": None})
        elif not reports:
            continue
        elif "spill stores" in line:
            found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
            reports[-1]["spills"] = (int(found[1]), int(found[2]))
        elif "Used" in line and "registers" in line:
            reports[-1]["registers"] = int(
                re.search(r"Used (\d+) registers", line)[1])
            found = re.search(r"(\d+) bytes smem", line)
            reports[-1]["smem"] = int(found[1]) if found else 0
    for report, name in zip(reports, _demangled([r["kernel"]
                                                 for r in reports])):
        report["name"] = name
    return reports


# kernels whose ptxas report must show no spill: the correlation's 98 sums
# per thread, the register windows of B1 and B2b and B2a's twenty tap loads
# a sample stay in registers; so do B5's, B11's and B12's few values (16-40
# registers), B9's strips and B10's strip of two rows (64 registers each),
# and B17's 49 exponentials a pixel
NO_SPILL = ("corr7x7", "poly_expansion", "update_equations",
            "aggregate_solve", "forward_scatter", "backward_resolve",
            "hs_derivatives", "hs_iterate", "lk_warp_products", "lk_window",
            "pyramid_levels_kernel", "lk_pyramid_kernel",
            "exact_backwarp_kernel", "upsample2x_phases_kernel",
            "reg_apply_kernel")


def phase_build() -> list[dict]:
    from transflow_tpu_torch._device import kernel_library
    lib = kernel_library()
    print(f"build: {lib.path.name} in {lib.build_seconds:.2f} s")
    reports = ptxas_reports(lib.build_log)
    for r in reports:
        print(f"  ptxas {r['name']}: {r['registers']} registers, "
              f"{r['smem']} bytes smem, spills {r['spills']}")
    for key in NO_SPILL:
        mine = [r for r in reports if key in r["kernel"]]
        if not mine or any(r["spills"] is None for r in mine):
            raise AssertionError(f"the build log holds no ptxas report of "
                                 f"spills for {key}: they are unchecked")
        spilled = [r["name"] for r in mine if r["spills"] != (0, 0)]
        if spilled:
            raise AssertionError(f"{key} spills: {spilled}")
    print(f"build: {len(reports)} ptxas reports, no spill in "
          f"{', '.join(NO_SPILL)}")
    return reports


def _pair(t1, t2) -> str:
    return f"{str(t1)[6:]}/{str(t2)[6:]}"


def phase_kernels(device) -> list[dict]:
    from transflow_tpu_torch.ops.correlation import (correlation7x7,
                                                     correlation7x7_cuda)
    gen = torch.Generator(device=device).manual_seed(SEED)
    rows = []
    for h, w, c, stride, level in CORR_SHAPES:
        for t1, t2 in DTYPE_PAIRS:
            f1 = torch.randn((h, w, c), generator=gen, device=device).to(t1)
            f2 = torch.randn((h, w, c), generator=gen, device=device).to(t2)
            got = correlation7x7_cuda(f1, f2, stride)
            want = correlation7x7(f1, f2, stride)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            ok = torch.allclose(got, want, atol=CORR_ATOL, rtol=CORR_RTOL)
            if not ok:
                raise AssertionError(
                    f"correlation kernel disagrees at {level} "
                    f"{_pair(t1, t2)}: max_abs_err {err}")
            row = {"level": level, "pair": (t1, t2), "err": err}
            row["bound_ms"], row["bound_by"] = corr_bound_ms(h, w, c, stride,
                                                             t1, t2)
            row["device_ms"] = device_ms(
                lambda: correlation7x7_cuda(f1, f2, stride))
            row["call_ms"] = call_ms(
                lambda: correlation7x7_cuda(f1, f2, stride))
            row["plain_ms"] = device_ms(
                lambda: correlation7x7(f1, f2, stride), PLAIN_LAUNCHES)
            if (t1, t2) == MAIN_PAIR[level]:  # profiled in phase 10
                row["call"] = functools.partial(correlation7x7_cuda, f1, f2,
                                                stride)
            print(f"corr {level} ({h},{w},{c}) s{stride} {_pair(t1, t2)}: "
                  f"max_abs_err {err:.3e} device_ms {row['device_ms']:.5f} "
                  f"bound {row['bound_ms']:.5f} "
                  f"({row['bound_by']}) share "
                  f"{row['bound_ms'] / row['device_ms']:.1%}; call "
                  f"{row['call_ms']:.4f} ms (host-inclusive); plain "
                  f"{row['plain_ms']:.4f} ms")
            rows.append(row)
    return rows


def warp_flow(h: int, w: int, bound: int, beyond: bool, gen, device):
    """(h, w, 2) f32 flow with floors inside [-bound, bound]; with
    ``beyond``, a fifth of the pixels move up to 3 bounds further."""
    flow = bound * (2 * torch.rand((h, w, 2), generator=gen,
                                   device=device) - 1)
    if beyond:
        far = torch.rand((h, w, 1), generator=gen, device=device) < 0.2
        step = bound + 1 + 2 * bound * torch.rand(
            (h, w, 2), generator=gen, device=device)
        flow = torch.where(far, torch.sign(flow) * step, flow)
    return flow


def pan_flow(h: int, w: int, device) -> torch.Tensor:
    """(h, w, 2) f32 flow of the Farneback Engine's pan (phase F) at a
    level h x w of the 1080p frame: ``FB_PAN`` px along both axes at L0,
    scaled with the level's width."""
    return torch.full((h, w, 2), FB_PAN * w / WIDTH, device=device)


def grid_sample_warp(image, flow, to_bf16: bool = True):
    """``F.grid_sample`` (bilinear, zero padding, corners aligned) of the
    (H, W, C) image, rounded to bf16 as bounded_backwarp reads it (or, with
    ``to_bf16`` False, in its own dtype as exact_backwarp reads it), at
    pixel + flow: bounded_backwarp's function while every floor lies
    within the bound, exact_backwarp's while every tap lies in the frame.
    Returns the call on prepared inputs: an (1, C, H, W) view of the image
    in f32 and the normalised grid."""
    h, w = flow.shape[:2]
    ys = torch.arange(h, device=flow.device, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=flow.device, dtype=torch.float32)[None, :]
    grid = torch.stack([(xs + flow[..., 0]) * (2 / (w - 1)) - 1,
                        (ys + flow[..., 1]) * (2 / (h - 1)) - 1], -1)[None]
    nchw = (image.to(BF16) if to_bf16 else image).float() \
        .permute(2, 0, 1)[None]
    return lambda: torch.nn.functional.grid_sample(
        nchw, grid, mode="bilinear", padding_mode="zeros",
        align_corners=True)


def grid_sample_tol(image, h: int, w: int) -> float:
    """How far ``grid_sample_warp`` may lie from A3: ``GRID_SAMPLE_ULPS``
    ulp of the frame's height and width, each times the image's range."""
    spread = (image.max() - image.min()).float().item()
    ulps = np.spacing(np.float32(h)) + np.spacing(np.float32(w))
    return float(GRID_SAMPLE_ULPS * ulps * spread)


def phase_warp_kernels(device) -> list[dict]:
    from transflow_tpu_torch.ops.warp import (bounded_backwarp_cuda,
                                              bounded_backwarp_plain)
    gen = torch.Generator(device=device).manual_seed(SEED)
    rows = []
    for h, w, c, bound, level in WARP_SHAPES:
        for dtype in (BF16, F32):
            image = torch.randn((h, w, c), generator=gen,
                                device=device).to(dtype)
            for beyond in (False, True):
                flow = warp_flow(h, w, bound, beyond, gen, device)
                clamped = (torch.floor(flow).abs() > bound).float().mean()
                got = bounded_backwarp_cuda(image, flow, bound)
                want = bounded_backwarp_plain(image, flow, bound)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                ok = torch.allclose(got, want, atol=WARP_ATOL,
                                    rtol=WARP_RTOL)
                kind = "beyond" if beyond else "within"
                if not ok:
                    raise AssertionError(
                        f"bounded backwarp disagrees at {level} "
                        f"{dtype} {kind}: max_abs_err {err}")
                if beyond and not clamped.item() > 0.1:
                    raise AssertionError(f"the clamp did not run at {level}")
                row = {"level": level, "dtype": dtype, "beyond": beyond,
                       "err": err}
                row["bound_ms"], row["bound_by"] = warp_bound_ms(h, w, c,
                                                                 dtype)
                row["device_ms"] = device_ms(
                    lambda: bounded_backwarp_cuda(image, flow, bound))
                row["call_ms"] = call_ms(
                    lambda: bounded_backwarp_cuda(image, flow, bound))
                row["plain_ms"] = device_ms(
                    lambda: bounded_backwarp_plain(image, flow, bound),
                    PLAIN_LAUNCHES)
                library = ""
                row["library_ms"] = None
                if not beyond:
                    sample = grid_sample_warp(image, flow)
                    lib_err = (sample()[0].permute(1, 2, 0)
                               - got).abs().max().item()
                    tol = grid_sample_tol(image, h, w)
                    if not lib_err <= tol:
                        raise AssertionError(
                            f"grid_sample disagrees with A3 at {level} "
                            f"{dtype}: |diff| {lib_err} > {tol}")
                    row["library_ms"] = device_ms(sample)
                    library = (f"; grid_sample {row['library_ms']:.5f} ms "
                               f"(|diff| {lib_err:.3e} <= {tol:.3e})")
                    if dtype == BF16:  # profiled in phase 10
                        row["call"] = functools.partial(
                            bounded_backwarp_cuda, image, flow, bound)
                        row["library_call"] = sample
                print(f"warp {level} ({h},{w},{c}) K={bound} "
                      f"{str(dtype)[6:]} {kind} (clamped "
                      f"{clamped.item():.3f}): max_abs_err {err:.3e} "
                      f"device_ms {row['device_ms']:.5f} bound "
                      f"{row['bound_ms']:.5f} share "
                      f"{row['bound_ms'] / row['device_ms']:.1%}; call "
                      f"{row['call_ms']:.4f} ms (host-inclusive); plain "
                      f"{row['plain_ms']:.4f} ms{library}")
                rows.append(row)
    return rows


def exact_warp_flow(h: int, w: int, gen, device, inside: bool = False):
    """(h, w, 2) f32 flow of ``B7_REACH`` px at L2 scaled to the level;
    ``B7_FAR`` of the pixels 1-3 frames outside it, or with ``inside``
    every tap clamped into the frame (floors within [0, n-2])."""
    reach = B7_REACH * w / B7_LEVELS[-1][1]
    flow = reach * (2 * torch.rand((h, w, 2), generator=gen,
                                   device=device) - 1)
    ii = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    jj = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    if inside:
        sx = (jj + flow[..., 0]).clamp(0, w - 1 - 1e-3)
        sy = (ii + flow[..., 1]).clamp(0, h - 1 - 1e-3)
        return torch.stack([sx - jj, sy - ii], -1)
    far = torch.rand((h, w, 1), generator=gen, device=device) < B7_FAR
    size = torch.tensor([w, h], dtype=torch.float32, device=device)
    away = size * (1 + 2 * torch.rand((h, w, 2), generator=gen,
                                      device=device))
    return torch.where(far, torch.sign(flow) * away, flow)


def phase_exact_warp_kernels(device) -> list[dict]:
    """Phase 7's B7 rows: the exact backwarp at the 9 feature warps'
    shapes of a 1088x1920 frame (bf16, the network's, and f32) and the 5
    regularization warps' (the 3-channel half of an f32 6-channel pair,
    read in place), bit-equal to the plain version on a flow whose taps
    stay in the frame and on one with far-out pixels. It is timed on the
    first (``far_ms``: on the second) beside ``F.grid_sample`` on the same
    inputs, where that call computes the same function: held to B7
    within ``grid_sample_tol`` and timed as the library-call yardstick."""
    from transflow_tpu_torch.ops.warp import (exact_backwarp_cuda,
                                              exact_backwarp_plain)
    gen = torch.Generator(device=device).manual_seed(SEED)
    cases = [("feature", h, w, c, level, dtype)
             for h, w, c, _, level in WARP_SHAPES for dtype in (BF16, F32)]
    cases += [("image", h, w, 3, level, F32) for h, w, level in B7_LEVELS]
    rows = []
    for kind, h, w, c, level, dtype in cases:
        if kind == "feature":
            image = torch.randn((h, w, c), generator=gen,
                                device=device).to(dtype)
        else:
            image = torch.rand((h, w, 6), generator=gen,
                               device=device)[..., 3:]
        flow = exact_warp_flow(h, w, gen, device, inside=True)
        far = exact_warp_flow(h, w, gen, device)
        errs = []
        for f in (far, flow):
            got = exact_backwarp_cuda(image, f)
            want = exact_backwarp_plain(image, f)
            torch.cuda.synchronize()
            errs.append((got - want).abs().max().item())
            if not torch.equal(got, want):
                raise AssertionError(
                    f"exact backwarp disagrees at {level} {kind} {dtype}: "
                    f"max_abs_err {errs[-1]}")
        sample = grid_sample_warp(image, flow, to_bf16=False)
        lib_err = (sample()[0].permute(1, 2, 0) - got).abs().max().item()
        tol = grid_sample_tol(image, h, w)
        if not lib_err <= tol:
            raise AssertionError(f"grid_sample disagrees with B7 at {level} "
                                 f"{kind} {dtype}: |diff| {lib_err} > {tol}")
        row = {"level": level, "kind": kind, "dtype": dtype,
               "err": max(errs), "main": dtype == BF16 or kind == "image",
               "per_frame": (WARP_PER_FRAME[level] if kind == "feature"
                             else 1)}
        row["bound_ms"], row["bound_by"] = exact_warp_bound_ms(h, w, c,
                                                               dtype)
        row["device_ms"] = device_ms(lambda: exact_backwarp_cuda(image, flow))
        row["far_ms"] = device_ms(lambda: exact_backwarp_cuda(image, far))
        row["call_ms"] = call_ms(lambda: exact_backwarp_cuda(image, flow))
        row["plain_ms"] = device_ms(lambda: exact_backwarp_plain(image, flow),
                                    PLAIN_LAUNCHES)
        row["plain_ops"] = aten_ops(lambda: exact_backwarp_plain(image, flow))
        row["library_ms"] = device_ms(sample)
        # profiled in phase 10
        row["call"] = functools.partial(exact_backwarp_cuda, image, flow)
        row["library_call"] = sample
        print(f"B7 {level} {kind} ({h},{w},{c}) {str(dtype)[6:]}: bit-equal "
              f"(max_abs_err {row['err']:.3e}) device_ms "
              f"{row['device_ms']:.5f} (a fifth of the pixels far out "
              f"{row['far_ms']:.5f}) bound {row['bound_ms']:.5f} "
              f"({row['bound_by']}) share "
              f"{row['bound_ms'] / row['device_ms']:.1%}; call "
              f"{row['call_ms']:.4f} ms (host-inclusive); plain "
              f"{row['plain_ms']:.4f} ms ({row['plain_ops']} ATen ops); "
              f"grid_sample {row['library_ms']:.5f} ms (|diff| "
              f"{lib_err:.3e} <= {tol:.3e})")
        rows.append(row)
    return rows


def up_bound_ms(h: int, w: int, c: int, dtype) -> tuple[float, str]:
    """B16's bound: the (h, w, C) input and the (C, 1, 4, 4) float32 taps
    read once, the (2h, 2w, C) output written once; per output value 4
    products and 3 sums."""
    nbytes = h * w * c * dtype.itemsize * 5 + 64 * c
    return _bound(nbytes, 7 * 4 * h * w * c)


def reg_bound_ms(h: int, w: int, size: int, dist_dtype, flow_dtype
                 ) -> tuple[float, str]:
    """B17's bound: the (H, W, S*S) distances and the (H, W, 2) flow read
    once, the f32 output written once (the 2 * S*S + 2 parameters too);
    per tap the square, the max, the difference, the exponential (counted
    as one operation), the sum, and two products and a sum an axis; per
    pixel the reciprocal, two sums and two products."""
    taps = size * size
    nbytes = (h * w * (taps * dist_dtype.itemsize + 2 * flow_dtype.itemsize
                       + 2 * 4) + 4 * (2 * taps + 2))
    return _bound(nbytes, h * w * (11 * taps + 5))


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Bit-equal where neither is NaN (the signs of zeros included), and
    NaN in the same places."""
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan):
        return False
    got, want = (torch.where(nan, 0, t) for t in (got, want))
    ints = torch.int16 if got.dtype == BF16 else torch.int32
    return torch.equal(got.view(ints), want.view(ints))


def conv_transpose_call(x, weight):
    """``F.conv_transpose2d(x, weight, stride=2, padding=1, groups=C)`` on
    an (1, C, h, w) float32 view of the (h, w, C) input, TF32 off: B16's
    function in one PyTorch call (cuDNN), as (1, C, 2h, 2w) in float32."""
    from transflow_tpu_torch.ops.image import exact_f32_convolutions
    nchw = x.float().permute(2, 0, 1)[None]

    def call():
        with exact_f32_convolutions(x.device):
            return torch.nn.functional.conv_transpose2d(
                nchw, weight, stride=2, padding=1, groups=x.shape[2])
    return call


def phase_lfn_head_kernels(device) -> tuple[list[dict], list[dict]]:
    """Phase 7b: B16 (``upsample2x_phases``) at its six 1088x1920 shapes in
    float32 (the path's) and bfloat16, and B17 (``reg_apply``) at its five
    levels with bf16 (the path's) and f32 distances, the flow in the
    path's dtype (bf16 at L6), then one bf16 L2 case with NaN distances;
    random inputs from the seed, each bit-equal to its plain version.
    Each row is timed (``device_ms``, ``call_ms``, the plain version's time
    and ATen ops; phase 10 adds the kernel time); B16's beside
    ``F.conv_transpose2d`` on the same input (TF32 off), held to B16
    within ``UP_LIBRARY_EPS`` epsilons of 4 max|x| max|taps| and timed as
    the library-call yardstick. No single PyTorch call computes B17."""
    from transflow_tpu_torch.ops.lfn_heads import (reg_apply_cuda,
                                                   reg_apply_plain,
                                                   upsample2x_phases_cuda,
                                                   upsample2x_phases_plain)
    gen = torch.Generator(device=device).manual_seed(SEED)
    up_rows, reg_rows = [], []
    for h, w, c, name in B16_SHAPES:
        for dtype in (F32, BF16):
            x = torch.randn((h, w, c), generator=gen, device=device).to(dtype)
            weight = 0.5 * torch.randn((c, 1, 4, 4), generator=gen,
                                       device=device)
            got = upsample2x_phases_cuda(x, weight)
            want = upsample2x_phases_plain(x, weight)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            if not _same_bits(got, want):
                raise AssertionError(f"B16 disagrees at {name} {dtype}: "
                                     f"max_abs_err {err}")
            library = conv_transpose_call(x, weight)
            lib_err = (library()[0].permute(1, 2, 0).float()
                       - got.float()).abs().max().item()
            eps = torch.finfo(dtype).eps
            tol = (UP_LIBRARY_EPS * eps * 4 * x.float().abs().max().item()
                   * weight.abs().max().item())
            if not lib_err <= tol:
                raise AssertionError(f"conv_transpose2d disagrees with B16 "
                                     f"at {name} {dtype}: |diff| {lib_err} "
                                     f"> {tol}")
            row = {"kernel": "upsample2x_phases", "level": name,
                   "dtype": dtype, "err": err, "main": dtype == F32}
            row["bound_ms"], row["bound_by"] = up_bound_ms(h, w, c, dtype)
            row["device_ms"] = device_ms(
                lambda: upsample2x_phases_cuda(x, weight))
            row["call_ms"] = call_ms(lambda: upsample2x_phases_cuda(x, weight))
            row["plain_ms"] = device_ms(
                lambda: upsample2x_phases_plain(x, weight), PLAIN_LAUNCHES)
            row["plain_ops"] = aten_ops(
                lambda: upsample2x_phases_plain(x, weight))
            row["library_ms"] = device_ms(library)
            # profiled in phase 10
            row["call"] = functools.partial(upsample2x_phases_cuda, x, weight)
            row["library_call"] = library
            print(f"B16 {name} ({h},{w},{c}) {str(dtype)[6:]}: bit-equal "
                  f"(max_abs_err {err:.3e}) device_ms "
                  f"{row['device_ms']:.5f} bound {row['bound_ms']:.5f} "
                  f"({row['bound_by']}) share "
                  f"{row['bound_ms'] / row['device_ms']:.1%}; call "
                  f"{row['call_ms']:.4f} ms (host-inclusive); plain "
                  f"{row['plain_ms']:.4f} ms ({row['plain_ops']} ATen ops); "
                  f"conv_transpose2d {row['library_ms']:.5f} ms (|diff| "
                  f"{lib_err:.3e} <= {tol:.3e})")
            up_rows.append(row)
    cases = [(h, w, size, name, dist_dtype, BF16 if name == "L6" else F32,
              False)
             for h, w, size, name in B17_LEVELS for dist_dtype in (BF16, F32)]
    cases.append((*B17_LEVELS[-1], BF16, F32, True))
    for h, w, size, name, dist_dtype, flow_dtype, nan in cases:
        taps = size * size
        dist = (1.5 * torch.randn((h, w, taps), generator=gen,
                                  device=device)).to(dist_dtype)
        if nan:  # one NaN distance in a tenth of the pixels
            hit = torch.rand((h, w), generator=gen, device=device) < 0.1
            dist[..., taps // 2][hit] = float("nan")
        reach = B7_REACH * w / B7_LEVELS[-1][1]
        flow = (reach * (2 * torch.rand((h, w, 2), generator=gen,
                                        device=device) - 1)).to(flow_dtype)
        params = [torch.randn(shape, generator=gen, device=device)
                  for shape in ((1, taps, 1, 1), (1,), (1, taps, 1, 1),
                                (1,))]
        got = reg_apply_cuda(dist, flow, *params)
        want = reg_apply_plain(dist, flow, *params)
        torch.cuda.synchronize()
        err = (got - want).nan_to_num(0.0).abs().max().item()
        if not _same_bits(got, want):
            raise AssertionError(f"B17 disagrees at {name} dist "
                                 f"{dist_dtype} flow {flow_dtype}"
                                 f"{' with NaNs' if nan else ''}: "
                                 f"max_abs_err {err}")
        kind = "NaN distances" if nan else "random"
        row = {"kernel": "reg_apply", "level": name, "dist": dist_dtype,
               "flow": flow_dtype, "kind": kind, "err": err,
               "main": dist_dtype == BF16 and not nan}
        row["bound_ms"], row["bound_by"] = reg_bound_ms(h, w, size,
                                                        dist_dtype, flow_dtype)
        row["device_ms"] = device_ms(lambda: reg_apply_cuda(dist, flow,
                                                            *params))
        row["call_ms"] = call_ms(lambda: reg_apply_cuda(dist, flow, *params))
        row["plain_ms"] = device_ms(lambda: reg_apply_plain(dist, flow,
                                                            *params),
                                    PLAIN_LAUNCHES)
        row["plain_ops"] = aten_ops(lambda: reg_apply_plain(dist, flow,
                                                            *params))
        # profiled in phase 10
        row["call"] = functools.partial(reg_apply_cuda, dist, flow, *params)
        print(f"B17 {name} ({h},{w},{taps}) dist {str(dist_dtype)[6:]} flow "
              f"{str(flow_dtype)[6:]} {kind}: bit-equal (max_abs_err "
              f"{err:.3e}, NaNs where the plain version's) device_ms "
              f"{row['device_ms']:.5f} bound {row['bound_ms']:.5f} "
              f"({row['bound_by']}) share "
              f"{row['bound_ms'] / row['device_ms']:.1%}; call "
              f"{row['call_ms']:.4f} ms (host-inclusive); plain "
              f"{row['plain_ms']:.4f} ms ({row['plain_ops']} ATen ops); no "
              "single PyTorch call computes it")
        reg_rows.append(row)
    return up_rows, reg_rows


def epilogue_bound_ms(shape, dtype, leaky: bool) -> tuple[float, str]:
    """B18's bound: cuDNN's output read once, the result written once (the
    C float32 biases too); per element the add, and with the leaky ReLU
    the sign test and the product."""
    n = shape[0] * shape[1] * shape[2] * shape[3]
    nbytes = 2 * n * dtype.itemsize + 4 * shape[3]
    return _bound(nbytes, n * (3 if leaky else 1))


def b18_input(shape, dtype, kind: str, gen, device):
    """Random (N, C, H, W) values (``shape`` is (N, H, W, C)) in the layout
    ``kind`` with exact zeros of both signs, and a float32 bias."""
    from transflow_tpu_torch.ops import conv_epilogue as ce
    n, h, w, c = shape
    y = 4 * torch.randn((n, h, w, c), generator=gen, device=device)
    flat = y.view(-1)
    flat[::13] = 0.0
    flat[5::13] = -0.0
    y = y.to(dtype).permute(0, 3, 1, 2)
    if kind == ce.NCHW:
        y = y.contiguous()
    return y, torch.randn(c, generator=gen, device=device)


def b18_replaced(y, bias, leaky: bool):
    """The ops B18 replaced, as ``_Conv`` ran them before it: the bias cast
    to y's dtype, the add on the permuted view made contiguous, then
    ``F.leaky_relu(x, 0.1)``."""
    out = (y.permute(0, 2, 3, 1) + bias.to(y.dtype)).contiguous()
    return torch.nn.functional.leaky_relu(out, 0.1) if leaky else out


def b18_path_calls(device) -> list[tuple]:
    """B18's calls in one bound-0 forward of the network on a random
    1088x1920 pair: ((N, H, W, C), dtype, layout, leaky) each."""
    from transflow_tpu_torch.flow.estimators import liteflownet as lfn
    from transflow_tpu_torch.ops import conv_epilogue as ce
    epilogue, calls = lfn.conv_epilogue, []

    def record(y, bias, leaky):
        n, c, h, w = y.shape
        calls.append(((n, h, w, c), y.dtype, ce.layout(y, bias, "B18"),
                      leaky))
        return epilogue(y, bias, leaky)
    net = lfn.get_weights(allow_random=True, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    i1, i2 = (torch.rand((B18_FRAME[0][0][1], B18_FRAME[0][0][2], 3),
                         generator=gen, device=device) for _ in range(2))
    lfn.conv_epilogue = record
    try:
        with torch.no_grad():
            net(i1, i2, warp_bound=0)
    finally:
        lfn.conv_epilogue = epilogue
    torch.cuda.synchronize()
    return calls


def phase_conv_epilogue_kernels(device) -> list[dict]:
    """Phase 7c: B18 (``conv_epilogue``) on the calls of one bound-0
    1088x1920 forward (held to ``B18_FRAME``; prints the layouts cuDNN
    returned), then at every (N, H, W, C) of ``B18_FRAME`` in bf16 (and
    f32 at L2) from both layouts, with and without the leaky ReLU, random
    inputs from the seed, each bit-equal to its plain version. The path's
    row of each entry (bf16, its layout and leaky ReLU) is timed
    (``device_ms`` in place, ``call_ms``, the plain version's time and ATen
    ops, and the ops it replaced, ``b18_replaced``; phase 10 adds the
    kernel times). No single PyTorch call adds a bias and takes a leaky
    ReLU."""
    from transflow_tpu_torch.ops import conv_epilogue as ce
    calls = b18_path_calls(device)
    seen = {}
    for shape, dtype, kind, leaky in calls:
        if dtype != BF16:
            raise AssertionError(f"B18 got {dtype} at {shape} on the path")
        seen.setdefault((shape, leaky), []).append(kind)
    want = {(shape, leaky): n for shape, leaky, n, _ in B18_FRAME}
    if {k: len(v) for k, v in seen.items()} != want:
        raise AssertionError(f"B18's calls a frame {seen}, expected {want}")
    kinds = [kind for _, _, kind, _ in calls]
    h, w = B18_FRAME[0][0][1:3]
    print(f"B18 a bound-0 {h}x{w} frame: {len(calls)} calls; cuDNN "
          f"returned {kinds.count(ce.CHANNELS_LAST)} channels_last and "
          f"{kinds.count(ce.NCHW)} contiguous NCHW outputs")
    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    rows = []
    for shape, path_leaky, count, name in B18_FRAME:
        path_kind = max(set(seen[shape, path_leaky]),
                        key=seen[shape, path_leaky].count)
        dtypes = (BF16, F32) if shape[1] == B18_FRAME[0][0][1] // 2 \
            else (BF16,)
        for dtype, kind, leaky in itertools.product(
                dtypes, (ce.CHANNELS_LAST, ce.NCHW), (True, False)):
            y, bias = b18_input(shape, dtype, kind, gen, device)
            want = ce.conv_epilogue_plain(y, bias, leaky)
            got = ce.conv_epilogue_cuda(y.clone(), bias, leaky)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            label = (f"{name} {shape} {str(dtype)[6:]} {kind}"
                     f"{' leaky' if leaky else ''}")
            if not _same_bits(got, want):
                raise AssertionError(f"B18 disagrees at {label}: "
                                     f"max_abs_err {err}")
            main = (dtype, kind, leaky) == (BF16, path_kind, path_leaky)
            row = {"kernel": "conv_epilogue", "level": name, "shape": shape,
                   "dtype": dtype, "err": err, "main": main, "count": count}
            rows.append(row)
            if not main:
                continue
            row["bound_ms"], row["bound_by"] = epilogue_bound_ms(
                shape, dtype, leaky)
            call = functools.partial(ce.conv_epilogue_cuda, y.clone(), bias,
                                     leaky)
            row["device_ms"] = device_ms(call)
            row["call_ms"] = call_ms(call)
            row["plain_ms"] = device_ms(
                lambda: ce.conv_epilogue_plain(y, bias, leaky),
                PLAIN_LAUNCHES)
            row["plain_ops"] = aten_ops(
                lambda: ce.conv_epilogue_plain(y, bias, leaky))
            replaced = functools.partial(b18_replaced, y, bias, leaky)
            row["replaced_ms"] = device_ms(replaced)
            row["replaced_ops"] = aten_ops(replaced)
            # profiled in phase 10
            row["call"], row["replaced_call"] = call, replaced
            print(f"B18 {label} x{count} a frame: bit-equal (max_abs_err "
                  f"{err:.3e}) device_ms {row['device_ms']:.5f} bound "
                  f"{row['bound_ms']:.5f} ({row['bound_by']}) share "
                  f"{row['bound_ms'] / row['device_ms']:.1%}; call "
                  f"{row['call_ms']:.4f} ms (host-inclusive); plain "
                  f"{row['plain_ms']:.4f} ms ({row['plain_ops']} ATen ops); "
                  f"the ops it replaced {row['replaced_ms']:.5f} ms "
                  f"({row['replaced_ops']} ATen ops)")
    print(f"B18: {len(rows)} cases bit-equal to the plain version "
          f"({sum(r['main'] for r in rows)} the path's)")
    return rows


def panned_frames(n: int, height: int, width: int, device,
                  step: int = 3) -> torch.Tensor:
    """(n, H, W, 3) uint8 frames: a smooth random texture panned by
    ``step`` pixels per frame along both axes, made on the device."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    margin = step * n
    coarse = torch.rand((1, 3, (height + margin) // 16 + 2,
                         (width + margin) // 16 + 2), generator=gen,
                        device=device)
    canvas = torch.nn.functional.interpolate(
        coarse, size=(height + margin, width + margin), mode="bicubic",
        align_corners=False)[0].permute(1, 2, 0)
    noise = torch.rand(canvas.shape, generator=gen, device=device)
    canvas = (canvas * 200 + noise * 55).clamp(0, 255).to(torch.uint8)
    return torch.stack([canvas[i * step:i * step + height,
                               i * step:i * step + width]
                        for i in range(n)])


def flagship_model(height: int, width: int, device):
    from transflow_tpu_torch.config import LayerConfig
    from transflow_tpu_torch.model import FlowTransferModel
    return FlowTransferModel(
        height, width,
        [LayerConfig(0, reset_mode="random", reset_random_factor=0.01)],
        method="liteflownet", device=device)


def run_frames(model, frames, pixmaps, key):
    """``model.step`` over frames[1:] from frames[0], ``key`` split once
    per frame; returns (frames out, raw flows)."""
    from transflow_tpu_torch import prng
    state = model.init_state(frames[0])
    numbers = model.default_frame_numbers()
    outs, flows = [], []
    for idx in range(1, len(frames)):
        key, sub = prng.split(key)
        state, rgb = model.step(state, frames[idx], pixmaps,
                                idx / model.framerate, sub, numbers)
        outs.append(rgb)
        flows.append(state["prev_flow"])
    return outs, flows


def phase_slice(device, card: str) -> dict:
    from transflow_tpu_torch import prng
    from transflow_tpu_torch.ops.conv_epilogue import conv_epilogue_cuda
    from transflow_tpu_torch.ops.correlation import correlation7x7_cuda
    from transflow_tpu_torch.ops.lfn_heads import (reg_apply_cuda,
                                                   upsample2x_phases_cuda)
    from transflow_tpu_torch.ops.warp import exact_backwarp_cuda
    counters = {"A1": correlation7x7_cuda, "B7": exact_backwarp_cuda,
                "B16": upsample2x_phases_cuda, "B17": reg_apply_cuda,
                "B18": conv_epilogue_cuda}
    os.environ["TRANSFLOW_LITEFLOWNET_RANDOM"] = "1"
    model = flagship_model(HEIGHT, WIDTH, device)
    frames = panned_frames(SLICE_FRAMES + 2, HEIGHT, WIDTH, device)
    pixmaps = model.default_pixmaps(SEED)
    numbers = model.default_frame_numbers()
    keys = prng.split(prng.key(SEED), SLICE_FRAMES + 2)
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    state, _ = model.step(model.init_state(frames[0]), frames[1], pixmaps,
                          0.0, keys[1], numbers)  # warm-up frame
    # per-frame checks reduce on the card; one readback at the end
    finite = torch.ones((), dtype=torch.bool, device=device)
    checksum = torch.zeros((), dtype=torch.int64, device=device)
    max_flow = torch.zeros((), device=device)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for idx in range(2, SLICE_FRAMES + 2):
        state, rgb = model.step(state, frames[idx], pixmaps,
                                idx / model.framerate, keys[idx], numbers)
        flow = state["prev_flow"]
        if rgb.shape != (HEIGHT, WIDTH, 3) or rgb.dtype != torch.uint8:
            raise AssertionError(f"bad frame {rgb.shape} {rgb.dtype}")
        if flow.shape != (HEIGHT, WIDTH, 2):
            raise AssertionError(f"bad flow shape {tuple(flow.shape)}")
        finite &= torch.isfinite(flow).all()
        checksum += rgb.sum(dtype=torch.int64)
        max_flow = torch.maximum(max_flow, flow.abs().max())
    finite, checksum, max_flow = (finite.item(), checksum.item(),
                                  max_flow.item())
    seconds = time.perf_counter() - start
    launches = {name: fn.launches for name, fn in counters.items()}
    frames_run = 1 + SLICE_FRAMES
    if not finite:
        raise AssertionError("non-finite flow")
    want = {name: n * frames_run
            for name, n in ({"A1": 5, "B7": B7_EXACT} | LFN_HEADS).items()}
    if launches != want:
        raise AssertionError(f"launches {launches} over {frames_run} "
                             f"frames, expected {want}")
    ms = 1e3 * seconds / SLICE_FRAMES
    print(f"slice {HEIGHT}x{WIDTH} liteflownet->moveref: {ms:.2f} ms/frame "
          f"{1e3 / ms:.2f} frames/s over {SLICE_FRAMES} frames "
          f"(max |flow| {max_flow:.4g}, checksum {checksum}) on {card}")
    print(f"correlation launches: {launches['A1']}, exact backwarp "
          f"launches: {launches['B7']}, phase upsampler: {launches['B16']}, "
          f"tap apply: {launches['B17']}, convolution epilogue: "
          f"{launches['B18']} over {frames_run} frames")
    return launches


def lfn_config(bound: int):
    """LiteFlowNet's flow config at ``lfn_warp_bound=bound``."""
    from transflow_tpu_torch.flow.sources.cv import CvFlowConfig
    return CvFlowConfig(method="liteflownet", lfn_warp_bound=bound)


def frame_source(frames, config, direction: str = "backward", **kwargs):
    """A ``FlowSource`` over (N, H, W[, 3]) uint8 frames on the device with
    the flow config ``config`` and the source options ``kwargs`` (mask,
    kernel, filters): the first item after a rewind carries a priming
    frame, as the cv2 source's do."""
    from transflow_tpu_torch.flow.sources.base import FlowItem, FlowSource

    class PannedFrameSource(FlowSource):
        yields_frames = True

        def _open_reader(self):
            self.height, self.width = frames.shape[1:3]
            self.base_length = len(frames) - 1

        def _rewind_reader(self, frame_index):
            self.pos = frame_index
            self.primed = False

        def _read_item(self):
            prime = None
            if not self.primed:
                prime = frames[self.pos]
                self.pos += 1
                self.primed = True
            if self.pos >= len(frames):
                raise StopIteration
            self.pos += 1
            return FlowItem(FlowItem.FRAME, frames[self.pos - 1],
                            prime=prime)

    source = PannedFrameSource(direction=direction, **kwargs)
    source.config = config
    return source.open()


def _launch_counters():
    from transflow_tpu_torch.ops.compositor import (composite_cuda,
                                                    layer_update_cuda,
                                                    leave_empty_sources_cuda)
    from transflow_tpu_torch.ops.conv_epilogue import conv_epilogue_cuda
    from transflow_tpu_torch.ops.correlation import (correlation7x7_cuda,
                                                     sharded_correlation7x7)
    from transflow_tpu_torch.ops.farneback import (aggregate_solve_cuda,
                                                   poly_expansion_cuda,
                                                   update_equations_cuda)
    from transflow_tpu_torch.ops.horn_schunck import (hs_derivatives_cuda,
                                                      hs_iterate_cuda)
    from transflow_tpu_torch.ops.lfn_heads import (reg_apply_cuda,
                                                   upsample2x_phases_cuda)
    from transflow_tpu_torch.ops.lucas_kanade import (lk_warp_products_cuda,
                                                      lk_window_solve_cuda)
    from transflow_tpu_torch.ops.pyramid import (lk_pyramid_cuda,
                                                 pyramid_levels_cuda)
    from transflow_tpu_torch.ops.scatter import forward_to_backward_cuda
    from transflow_tpu_torch.ops.warp import (bounded_backwarp_cuda,
                                              exact_backwarp_cuda)
    return (bounded_backwarp_cuda, correlation7x7_cuda,
            sharded_correlation7x7, poly_expansion_cuda,
            update_equations_cuda, aggregate_solve_cuda,
            forward_to_backward_cuda, hs_derivatives_cuda, hs_iterate_cuda,
            lk_warp_products_cuda, lk_window_solve_cuda,
            leave_empty_sources_cuda, layer_update_cuda, composite_cuda,
            pyramid_levels_cuda, lk_pyramid_cuda, exact_backwarp_cuda,
            upsample2x_phases_cuda, reg_apply_cuda, conv_epilogue_cuda)


# the names of _launches()'s entries
KERNEL_NAMES = ("A3", "A1", "A2", "B1", "B2a", "B2b", "B5", "B9", "B10",
                "B11", "B12", "K0", "K1", "K2", "B8", "B14", "B7", "B16",
                "B17", "B18")


def fb_launches(launches) -> tuple:
    """The Farneback kernels' entries of a ``KERNEL_NAMES`` tuple, in
    ``launches_per_frame``'s order (``FB_NAMES``)."""
    return tuple(launches[KERNEL_NAMES.index(n)] for n in FB_NAMES)


def fb_row(per_frame: tuple, comp: tuple = C_MOVEREF) -> tuple:
    """``KERNEL_NAMES`` launches a frame of a Farneback Engine: the
    estimator's ``per_frame`` (``FB_NAMES``) and the compositor's ``comp``
    (K0, K1, K2), no other kernel."""
    named = dict(zip(FB_NAMES, per_frame)) | dict(zip(("K0", "K1", "K2"),
                                                       comp))
    return tuple(named.get(n, 0) for n in KERNEL_NAMES)


def lfn_row(comp: tuple = C_MOVEREF, **named: int) -> tuple:
    """``KERNEL_NAMES`` launches a frame of a LiteFlowNet Engine: the
    network's ``named`` counts, its heads' ``LFN_HEADS`` and the
    compositor's ``comp`` (K0, K1, K2), no other kernel."""
    named = LFN_HEADS | named | dict(zip(("K0", "K1", "K2"), comp))
    return tuple(named.get(n, 0) for n in KERNEL_NAMES)
# the compositor's K0, K1, K2 launches a frame under a mesh that splits
# the movement: the moveref layer updates through its plain ops and the
# stack renders through K2
C_MESH = (0, 0, C_MOVEREF[2])


def _launches() -> tuple[int, ...]:
    """The launches of each kernel of ``KERNEL_NAMES`` since the counts
    were last set to 0."""
    return tuple(fn.launches for fn in _launch_counters())


def _zero_launches() -> None:
    for fn in _launch_counters():
        fn.launches = 0


def make_engine(device, frames, config, mesh=None, halo: int | None = None):
    """(Engine, its frame source) with the flow config ``config``, one
    moveref layer with random reset 0.01."""
    from transflow_tpu_torch.compositor.core import make_layer_params
    from transflow_tpu_torch.config import Config, LayerConfig
    from transflow_tpu_torch.engine import Engine
    source = frame_source(frames, config)
    layer_params = make_layer_params(
        [LayerConfig(0, reset_mode="random", reset_random_factor=0.01)],
        HEIGHT, WIDTH, {0: [(3, None)]}, device=device)
    engine = Engine(Config("synthetic", direction="backward", seed=SEED),
                    [source], layer_params, HEIGHT, WIDTH,
                    export_flows=True, device=device, mesh=mesh, halo=halo)
    return engine, source


def run_engine(device, frames, pixmap, config, mesh=None,
               halo: int | None = None) -> dict:
    """The Engine over ``frames`` with the flow config ``config``: a
    warm-up chunk, a timed chunk, then ``process_frame`` calls, with the
    kernels' launches (``KERNEL_NAMES``) counted from just before the timed
    chunk. The Engine and its remaining items stay in the result."""
    engine, source = make_engine(device, frames, config, mesh, halo)
    pixmaps, slots = ((pixmap,),), ((None,),)
    items = iter(source)
    warm = [next(items) for _ in range(ENGINE_WARMUP)]
    engine.runtimes[0].reset(warm[0].prime)
    engine.process_chunk([torch.stack([it.array for it in warm])], pixmaps,
                         slots, 0, 0)
    chunk = torch.stack([next(items).array for _ in range(ENGINE_FRAMES)])
    torch.cuda.synchronize()
    _zero_launches()
    start = time.perf_counter()
    out, flows = engine.process_chunk([chunk], pixmaps, slots,
                                      ENGINE_WARMUP, ENGINE_WARMUP)
    finite = torch.isfinite(flows).all()
    max_flow = flows.abs().max()
    checksum = out.sum(dtype=torch.int64)
    finite, max_flow, checksum = (finite.item(), max_flow.item(),
                                  checksum.item())
    seconds = time.perf_counter() - start
    chunk_launches = _launches()
    call_frames, call_flows = [], []
    for k in range(ENGINE_CALLS):
        fno = ENGINE_WARMUP + ENGINE_FRAMES + k
        frame, flow = engine.process_frame([next(items)], pixmaps,
                                           fno / 30.0, ((fno,),))
        if frame.shape != (HEIGHT, WIDTH, 3) or frame.dtype != torch.uint8:
            raise AssertionError(f"bad frame {frame.shape} {frame.dtype}")
        finite = finite and torch.isfinite(flow).all().item()
        call_frames.append(frame)
        call_flows.append(flow)
    torch.cuda.synchronize()

    def step(fno):
        engine.process_frame([next(items)], pixmaps, fno / 30.0, ((fno,),))

    return {"ms": 1e3 * seconds / ENGINE_FRAMES, "out": out, "flows": flows,
            "call_frames": torch.stack(call_frames),
            "call_flows": torch.stack(call_flows),
            "finite": finite, "max_flow": max_flow, "checksum": checksum,
            "chunk_launches": chunk_launches, "launches": _launches(),
            "engine": engine, "items": items, "pixmaps": pixmaps,
            "step": step,
            "next_fno": ENGINE_WARMUP + ENGINE_FRAMES + ENGINE_CALLS}


def _check_engine_run(name: str, run: dict, per_frame: tuple) -> None:
    """Launches (``KERNEL_NAMES``) per frame over the chunk and over all
    calls, finite flows and well-formed frames."""
    frames_run = ENGINE_FRAMES + ENGINE_CALLS
    want_chunk = tuple(n * ENGINE_FRAMES for n in per_frame)
    want_all = tuple(n * frames_run for n in per_frame)
    if run["chunk_launches"] != want_chunk or run["launches"] != want_all:
        raise AssertionError(
            f"{name}: {KERNEL_NAMES} launches {run['chunk_launches']} over "
            f"the chunk, {run['launches']} in all; expected {per_frame} per "
            "frame")
    if not run["finite"]:
        raise AssertionError(f"{name}: non-finite flow")
    if run["out"].shape != (ENGINE_FRAMES, HEIGHT, WIDTH, 3) or \
            run["out"].dtype != torch.uint8:
        raise AssertionError(f"{name}: bad frames {tuple(run['out'].shape)} "
                             f"{run['out'].dtype}")


def _per_frame_text(run: dict) -> str:
    """The chunk's launches per frame of every kernel that ran."""
    return ", ".join(f"{name} {n / ENGINE_FRAMES:g}"
                     for name, n in zip(KERNEL_NAMES, run["chunk_launches"])
                     if n) or "none"


def gray_frames(n: int, height: int, width: int, device) -> torch.Tensor:
    """(n, H, W) uint8 gray frames: the first channel of ``panned_frames``,
    panned by ``FB_PAN`` pixels per frame along both axes."""
    return panned_frames(n, height, width, device,
                         step=FB_PAN)[..., 0].contiguous()


def phase_farneback_engine(device, card: str) -> dict:
    """The 1080p Engine over CvFlowConfig() (the main path: the headline
    command's estimator), then over the fast, fastest and select-warp
    settings and over CvFlowConfig() again, on the same frames; returns the
    runs by name."""
    from transflow_tpu_torch.flow.estimators.farneback import \
        launches_per_frame
    from transflow_tpu_torch.flow.sources.cv import CvFlowConfig
    configs = Path(__file__).resolve().parent / "assets" / "configs"
    settings = {"CvFlowConfig()": CvFlowConfig(),
                "fast.json": CvFlowConfig.from_file(configs / "fast.json"),
                "fastest.json": CvFlowConfig.from_file(
                    configs / "fastest.json"),
                "fb_select_warp=16": CvFlowConfig(fb_select_warp=FB_RADIUS),
                # the first run of a process reads slower: the default again
                "CvFlowConfig() again": CvFlowConfig()}
    # and one frame for phase 11's capture of B2a's inputs
    n = (1 + ENGINE_WARMUP + ENGINE_FRAMES + ENGINE_CALLS + FB_SYNC_CALLS
         + FB_PROFILE_CALLS + 1)
    frames = gray_frames(n, HEIGHT, WIDTH, device)
    pixmap = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 256, (HEIGHT, WIDTH, 3), dtype=np.uint8)).to(device)
    runs = {}
    for name, config in settings.items():
        run = run_engine(device, frames, pixmap, config)
        per_frame = launches_per_frame(HEIGHT, WIDTH,
                                       **config.estimator_kwargs())
        default = name.startswith("CvFlowConfig()")
        if default and per_frame != FB_DEFAULT_PER_FRAME:
            raise AssertionError(f"CvFlowConfig() gives {per_frame} "
                                 f"{FB_NAMES} launches, not "
                                 f"{FB_DEFAULT_PER_FRAME}")
        _check_engine_run(f"farneback {name}", run, fb_row(per_frame))
        m = FB_MARGIN
        inner = torch.cat([run["flows"], run["call_flows"]])[:, m:-m, m:-m]
        medians = inner.reshape(len(inner), -1, 2).median(dim=1).values
        worst = (medians - FB_PAN).abs().max().item()
        print(f"farneback engine {HEIGHT}x{WIDTH} {name} ->moveref: "
              f"{run['ms']:.2f} ms/frame {1e3 / run['ms']:.2f} frames/s over "
              f"a chunk of {ENGINE_FRAMES} (max |flow| "
              f"{run['max_flow']:.4g}, checksum {run['checksum']}) on {card}")
        print(f"farneback engine {name} launches per frame: "
              f"{_per_frame_text(run)}; interior median flow per frame "
              f"{[tuple(round(v, 3) for v in r) for r in medians.tolist()]} "
              f"(pan {FB_PAN}, worst |median - pan| {worst:.4f})")
        if default and not worst <= FB_PAN_TOL:
            raise AssertionError(f"farneback {name}: an interior median flow "
                                 f"is {worst} px from the {FB_PAN} px pan")
        run["syncs"] = host_syncs(run, FB_SYNC_CALLS)
        print(f"farneback engine {name}: {run['syncs']:g} host syncs per "
              f"frame (torch.cuda.set_sync_debug_mode, {FB_SYNC_CALLS} "
              "process_frame call)")
        runs[name] = run
    return runs


# phase P: the CLI disk to disk over a netpbm sequence
P_FRAMES = 24         # P5 frames written; 23 flows
P_CUT = "00:00:00.480"  # -t: 12 frames at the sequence's 25 frames/s
P_CUT_FRAMES = 12
P_CHECKPOINT = 12     # --checkpoint-every of the run P3 resumes
P5_CUT = "00:00:00.160"  # -t of the subprocess run: 4 frames
P5_FRAMES = 4
P_TIMEOUT = 300       # seconds for the subprocess run


def _p_frames(directory: Path, n: int) -> list[np.ndarray]:
    """The ``n`` frames of a ``%04d.ppm`` output, each checked to decode
    to HEIGHT x WIDTH x 3."""
    from transflow_tpu_torch.utils.imageio import read_netpbm
    frames = []
    for i in range(n):
        frame = read_netpbm(str(directory / f"{i:04d}.ppm"))
        if frame.shape != (HEIGHT, WIDTH, 3):
            raise AssertionError(f"{directory}/{i:04d}.ppm decodes to "
                                 f"{frame.shape}")
        frames.append(frame)
    if (directory / f"{n:04d}.ppm").exists():
        raise AssertionError(f"{directory} holds more than {n} frames")
    return frames


def _p_flows(path: Path) -> np.ndarray:
    """The (N, H, W, 2) flows of a ``.flow.zip``, read by the port."""
    from transflow_tpu_torch.flow.sources.archive import ArchiveFlowSource
    source = ArchiveFlowSource(str(path)).open()
    try:
        return np.stack([np.array(item.array) for item in source])
    finally:
        source.close()


def _p_equal(name: str, got: list, want: list) -> None:
    if len(got) != len(want) or not all(
            np.array_equal(a, b) for a, b in zip(got, want)):
        bad = [i for i, (a, b) in enumerate(zip(got, want))
               if not np.array_equal(a, b)]
        raise AssertionError(f"{name}: {len(got)} arrays against "
                             f"{len(want)}, unequal at {bad[:8]}")


def _p_run(argv: list[str], count_syncs: bool = False) -> dict:
    """``cli.main(argv)`` on the card with the launches counted from 0
    (and the host's syncs where asked); returns the Pipeline, the wall
    time, the launches and the syncs."""
    import warnings
    from transflow_tpu_torch import cli
    torch.cuda.synchronize()
    _zero_launches()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if count_syncs:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            start = time.perf_counter()
            pipeline = cli.main(argv + ["--no-exec", "--overwrite"])
            seconds = time.perf_counter() - start
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return {"pipeline": pipeline, "seconds": seconds,
            "launches": _launches(),
            "syncs": sum("synchroniz" in str(w.message) for w in caught)}


def _p_split(run: dict, frames: int) -> str:
    """The disk-to-disk rate and StageTimers' split of a run: each
    stage's total ms over the run and per frame (the main thread's setup,
    decode_wait, device_step, checkpoint and flush; the readback
    thread's readback and flow_export; the encode thread's encode)."""
    stages = run["pipeline"].timers.report()["stages"]
    split = ", ".join(f"{name} {row['total_s'] * 1e3:.1f} "
                      f"({row['total_s'] * 1e3 / frames:.3f}/frame)"
                      for name, row in stages.items())
    return (f"{frames / run['seconds']:.2f} frames/s disk to disk "
            f"({run['seconds'] * 1e3 / frames:.2f} ms/frame, setup "
            f"included; stage ms: {split})")


def p_tools(root: Path, card: str, gray, flows, frames_arg: str) -> None:
    """The tools (``transflow_tpu_torch/tools``) over phase P's outputs:
    ``viewflow --stats`` over P1's ``-F`` archive (its means and maxima
    numpy's over the archive's flows), the render mode over the same
    archive (as many frames as flows), ``ControlSession`` over P1's end
    checkpoint (a HEIGHT x WIDTH mapping, a paint that shows in
    ``preview()``) and ``FlowClip.flow(0)`` over P's frames on the card
    (bit-equal to Farneback called directly on the pair, its B1, B2a, B2b
    and B8 launches those of the estimator's levels and iterations)."""
    import contextlib
    import io
    from transflow_tpu_torch.flow.estimators.farneback import (
        farneback, launches_per_frame)
    from transflow_tpu_torch.tools import control, viewflow, viewflow_player
    flows_n = len(flows)
    archive = str(root / "p1" / "%04d.flow.zip")
    buffer = io.StringIO()
    with contextlib.redirect_stdout(buffer):
        viewflow.main([archive, "--stats"])
    lines = buffer.getvalue().splitlines()
    mags = np.linalg.norm(flows, axis=-1)
    want = [f"frame {i:5d}: mean |f| {m.mean():7.3f}  max |f| "
            f"{m.max():7.3f}  moving {np.mean(m > 0.5):6.1%}"
            for i, m in enumerate(mags)]
    if lines[1:] != want:
        raise AssertionError(f"viewflow --stats: {lines[1:3]} against "
                             f"numpy's {want[:2]}")
    out = root / "viewflow"
    out.mkdir()
    start = time.perf_counter()
    viewflow.main([archive, "-o", str(out / "%04d.ppm")])
    render_s = time.perf_counter() - start
    rendered = _p_frames(out, flows_n)
    print(f"tools viewflow: --stats over P1's archive ({lines[0]}) equal "
          f"to numpy's means and maxima; the render mode (--view-flow, "
          f"the port's CLI on the card) wrote {len(rendered)} frames in "
          f"{render_s:.2f} s")
    session = control.ControlSession(
        str(root / "p1" / f"%04d_{flows_n:05d}.ckpt.zip"))
    i, j = HEIGHT // 2, WIDTH // 2
    session.paint(i, j, "red", radius=2)
    if (session.height, session.width) != (HEIGHT, WIDTH) or \
            tuple(session.preview()[i, j]) != (255, 0, 0):
        raise AssertionError(f"ControlSession: a {session.height}x"
                             f"{session.width} mapping, preview "
                             f"{session.preview()[i, j]} at the paint")
    clip = viewflow_player.FlowClip(frames_arg)
    torch.cuda.synchronize()
    _zero_launches()
    flow = clip.flow(0)
    launches = fb_launches(_launches())
    direct = farneback(gray[1], gray[0]).cpu()
    # farneback's defaults
    per_pair = launches_per_frame(*gray.shape[1:])
    if not torch.equal(torch.from_numpy(flow), direct) or \
            launches != per_pair:
        raise AssertionError(f"FlowClip.flow(0): bit-equal "
                             f"{torch.equal(torch.from_numpy(flow), direct)}"
                             f", B1/B2a/B2b/B8 launches {launches} "
                             "against "
                             f"{per_pair}")
    print(f"tools control: ControlSession over P1's end checkpoint, a "
          f"{session.width}x{session.height} mapping, a paint shown in "
          f"preview(); viewflow_player: FlowClip over {len(clip) + 1} P5 "
          f"frames, flow(0) on the card bit-equal to farneback on the pair, "
          f"B1/B2a/B2b/B8 launches {launches} (farneback's defaults: "
          f"{per_pair}); on {card}")


def phase_pipeline(device, card: str) -> dict:
    """Phase P: the port's CLI (``cli.main``) disk to disk at 1080x1920
    over 24 P5 frames panned 3 px per frame, with the headline command's
    defaults (CvFlowConfig(), backward flow, one moveref layer), a seeded
    noise pixmap, random reset 0.01, ``%04d.ppm`` frames, ``-F`` and
    ``-C``; then per frame (P2), the checkpoint and its resume (P3), the
    replay of P1's flows (P4) and ``python3 -m transflow_tpu_torch`` over
    a pixmap sequence (P5). Returns the rates."""
    import tempfile
    from transflow_tpu_torch.flow.sources.cv import CvFlowConfig
    from transflow_tpu_torch.utils.imageio import write_netpbm
    flows_n = P_FRAMES - 1
    per_frame = fb_row(FB_DEFAULT_PER_FRAME)
    gray = gray_frames(P_FRAMES, HEIGHT, WIDTH, device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_p_") as tmp:
        root = Path(tmp)
        (root / "frames").mkdir()
        for i, frame in enumerate(gray.cpu().numpy()):
            write_netpbm(str(root / "frames" / f"{i:04d}.pgm"), frame)
        frames_arg = str(root / "frames" / "%04d.pgm")

        def argv(out: str, *extra: str) -> list[str]:
            (root / out).mkdir(exist_ok=True)
            return [frames_arg, "-p", "noise", "-r", "random", "0.01",
                    "--seed", str(SEED), "-o", str(root / out / "%04d.ppm"),
                    "-F", "-C", *extra]

        # P1: the headline command, auto-chunked
        p1 = _p_run(argv("p1"), count_syncs=True)
        if p1["launches"] != tuple(n * flows_n for n in per_frame):
            raise AssertionError(
                f"P1: {KERNEL_NAMES} launches {p1['launches']}, expected "
                f"{per_frame} per frame over {flows_n} frames")
        engine = p1["pipeline"].engine
        places = {t.device for layer in engine.comp_state
                  for t in layer.values()} | {engine.device}
        if places != {device}:
            raise AssertionError(f"P1: the Engine's state is on {places}, "
                                 f"not {device}")
        frames1 = _p_frames(root / "p1", flows_n)
        flows1 = _p_flows(root / "p1" / "%04d.flow.zip")
        m = FB_MARGIN
        medians = np.median(flows1[:, m:-m, m:-m].reshape(flows_n, -1, 2),
                            axis=1)
        worst = float(np.abs(medians - FB_PAN).max())
        if flows1.shape != (flows_n, HEIGHT, WIDTH, 2) or \
                not worst <= FB_PAN_TOL:
            raise AssertionError(f"P1: flows {flows1.shape}, worst "
                                 f"|median - pan| {worst}")
        print(f"pipeline P1 {HEIGHT}x{WIDTH} CLI {flows_n} frames: "
              f"{_p_split(p1, flows_n)}; launches per frame "
              f"{tuple(n / flows_n for n in p1['launches'])} "
              f"{KERNEL_NAMES}; worst |median - pan| {worst:.4f}; on {card}")
        # P3's cut: the same with -t, as a baseline for the syncs a frame
        # adds, and its frames must be P1's first ones
        cut = _p_run(argv("p3cut", "-t", P_CUT), count_syncs=True)
        _p_equal("P3 cut frames", _p_frames(root / "p3cut", P_CUT_FRAMES),
                 frames1[:P_CUT_FRAMES])
        marginal = (p1["syncs"] - cut["syncs"]) / (flows_n - P_CUT_FRAMES)
        print(f"pipeline host syncs: {p1['syncs']} over P1's {flows_n} "
              f"frames, {cut['syncs']} over the {P_CUT_FRAMES}-frame cut "
              f"(-t {P_CUT}), so {marginal:g} per frame beyond setup "
              "(torch.cuda.set_sync_debug_mode)")
        # P2: the same, one frame at a time
        p2 = _p_run(argv("p2", "--batch-frames", "1"))
        if p2["pipeline"]._batch_size != 1 or \
                p1["pipeline"]._batch_size <= 1:
            raise AssertionError("P1 ran unchunked or P2 chunked")
        _p_equal("P2 frames", _p_frames(root / "p2", flows_n), frames1)
        _p_equal("P2 flows", list(_p_flows(root / "p2" / "%04d.flow.zip")),
                 list(flows1))
        print(f"pipeline P2 (--batch-frames 1): {_p_split(p2, flows_n)}; "
              "frames and flows bit-equal to P1's")
        # P3: a checkpoint at frame 12, resumed
        _p_run(argv("p3", "--checkpoint-every", str(P_CHECKPOINT)))
        _p_equal("P3 frames", _p_frames(root / "p3", flows_n), frames1)
        for i in range(P_CHECKPOINT, flows_n):
            (root / "p3" / f"{i:04d}.ppm").unlink()
        ckpt = root / "p3" / f"%04d_{P_CHECKPOINT:05d}.ckpt.zip"
        resumed = _p_run([str(ckpt)])
        if resumed["pipeline"].cursor != flows_n - P_CHECKPOINT:
            raise AssertionError(f"P3: the resume rendered "
                                 f"{resumed['pipeline'].cursor} frames")
        _p_equal("P3 resumed frames", _p_frames(root / "p3", flows_n),
                 frames1)
        print(f"pipeline P3: frames {P_CHECKPOINT}-{flows_n - 1} resumed "
              f"from {ckpt.name} bit-equal to P1's; the -t {P_CUT} cut's "
              f"{P_CUT_FRAMES} frames bit-equal to P1's first")
        # P4: the replay of P1's flows
        (root / "p4").mkdir()
        p4 = _p_run([str(root / "p1" / "%04d.flow.zip"), "-p", "noise",
                     "-r", "random", "0.01", "--seed", str(SEED), "-o",
                     str(root / "p4" / "%04d.ppm")])
        if p4["launches"] != tuple(flows_n * x for x in fb_row(
                (0, 0, 0, 0))):
            raise AssertionError(f"P4: launches {p4['launches']} "
                                 f"{KERNEL_NAMES}: only the compositor's "
                                 f"{C_MOVEREF} a frame may run")
        _p_equal("P4 frames", _p_frames(root / "p4", flows_n), frames1)
        print(f"pipeline P4 (replay of P1's .flow.zip): "
              f"{_p_split(p4, flows_n)}; frames bit-equal to P1's")
        p_tools(root, card, gray, flows1, frames_arg)
        # P5: the module entry point over a pixmap sequence
        (root / "pix").mkdir()
        rgb = panned_frames(P_FRAMES, HEIGHT, WIDTH, device).cpu().numpy()
        for i, frame in enumerate(rgb):
            write_netpbm(str(root / "pix" / f"{i:04d}.ppm"), frame)
        (root / "p5").mkdir()
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(Path(__file__).resolve().parent)]
            + [p for p in [env.get("PYTHONPATH")] if p])
        start = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "transflow_tpu_torch", frames_arg, "-p",
             str(root / "pix" / "%04d.ppm"), "-t", P5_CUT, "--seed",
             str(SEED), "-o", str(root / "p5" / "%04d.ppm"), "-F",
             "--no-exec", "--overwrite"], cwd=root, env=env,
            capture_output=True, text=True, timeout=P_TIMEOUT)
        seconds = time.perf_counter() - start
        if proc.returncode != 0:
            raise AssertionError(f"P5: exit {proc.returncode}\n"
                                 f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
        _p_frames(root / "p5", P5_FRAMES)
        _p_equal("P5 flows", list(_p_flows(root / "p5" / "%04d.flow.zip")),
                 list(flows1[:P5_FRAMES]))
        print(f"pipeline P5: python3 -m transflow_tpu_torch over a "
              f"{P_FRAMES}-frame pix/%04d.ppm pixmap, {P5_FRAMES} frames in "
              f"{seconds:.2f} s (process start included), flows bit-equal "
              "to P1's first")
        # the bare Engine on the same frames, for the Pipeline's own cost
        pixmap = torch.from_numpy(np.random.default_rng(SEED).integers(
            0, 256, (HEIGHT, WIDTH, 3), dtype=np.uint8)).to(device)
        bare = run_engine(device, gray, pixmap, CvFlowConfig())
        d2d_ms = p1["seconds"] * 1e3 / flows_n
        print(f"pipeline against the bare Engine on the same frames: "
              f"{bare['ms']:.2f} ms/frame (a chunk of {ENGINE_FRAMES}, "
              f"phase F's measure) against P1's {d2d_ms:.2f} and P4's "
              f"{p4['seconds'] * 1e3 / flows_n:.2f} ms/frame disk to disk; "
              f"on {card}")
    return {"p1_fps": flows_n / p1["seconds"],
            "p4_fps": flows_n / p4["seconds"], "engine_ms": bare["ms"]}


# phase T: flow post-processing, the merges and every layer class at 1080p
T_PANS = (3, -2)      # px per frame of the two sources' gray frames
T_FILTERS = ("scale=1.5;clip=8", "polar=r:a+0.1*t")
T_FLOW_MASK = "circle:45%"
T_INTRO_MASK = "circle:40%"
T_MOVE_SRC = "rect:90%:90%"
T_MOVE_DST = "circle:48%"
# each layer's --mask-alpha, bottom to top: a 3-channel pixmap's alpha is
# 0 or 1, so only a 0/1 mask leaves it visible
T_ALPHA = ("ones", "rect:90%:90%", "border:40", "circle:35%")
# the Engine's launches per frame: B1, B2a, B2b for two CvFlowConfig()
# sources, and B5's two for the forward one
# and K0, K1, K2: the moveref layer leaves empty spots (K0), the sum and
# the moveref layer update through K1, the stack renders in one K2
T_PER_FRAME = (0, 0, 0, 8, 24, 24, 2, 0, 0, 0, 0, 1, 2, 1, 2, 0, 0, 0, 0,
               0)
T_CLI_FRAMES = 12     # frames written for the CLI run; 11 flows
T_SYNC_CALLS = 2
T_PROFILE_CALLS = 3
T_TWIN = (128, 192)
T_TWIN_FRAMES = 4


def t_gray(n: int, pan: int, height: int, width: int, device):
    """(n, H, W) uint8 gray frames panned ``pan`` px per frame along both
    axes (a negative pan runs a positive one backwards)."""
    frames = panned_frames(n, height, width, device, step=abs(pan))[..., 0]
    return (frames if pan > 0 else frames.flip(0)).contiguous()


def t_files(root: Path, height: int, width: int) -> dict:
    """The phase's mask image (a wrapped gradient PGM: a fractional reset
    mask) and its 5x5 dyadic ``--kernel`` (``.npy``)."""
    from transflow_tpu_torch.utils.imageio import write_netpbm
    ii, jj = np.indices((height, width))
    gradient = root / "gradient.pgm"
    write_netpbm(str(gradient), ((ii // 4 + jj // 8) % 256).astype(np.uint8))
    taps = np.array([1, 4, 6, 4, 1], np.float32)
    kernel = root / "kernel.npy"
    np.save(kernel, np.outer(taps, taps) / 256)
    return {"gradient": str(gradient), "kernel": str(kernel)}


def t_layers(files: dict) -> list[dict]:
    """introduction, sum, static and moveref, each with an alpha mask
    (``T_ALPHA``) and the moving layers with both movement masks; random
    reset 0.01 under the fractional reset mask on sum and moveref."""
    moves = dict(mask_src=T_MOVE_SRC, mask_dst=T_MOVE_DST)
    reset = dict(reset_mode="random", reset_random_factor=0.01,
                 reset_mask=files["gradient"])
    return [dict(classname="introduction", mask_alpha=T_ALPHA[0],
                 moving_pixels_leave_empty_spot=True, **moves),
            dict(classname="sum", mask_alpha=T_ALPHA[1], **moves, **reset),
            dict(classname="static", mask_alpha=T_ALPHA[2]),
            dict(classname="moveref", mask_alpha=T_ALPHA[3],
                 moving_pixels_leave_empty_spot=True, **moves, **reset)]


def t_layer_params(files: dict, height: int, width: int, device):
    from transflow_tpu_torch.compositor.core import make_layer_params
    from transflow_tpu_torch.config import LayerConfig
    from transflow_tpu_torch.utils import load_bool_mask
    intro = load_bool_mask(T_INTRO_MASK, (height, width))
    return make_layer_params(
        [LayerConfig(i, **k) for i, k in enumerate(t_layers(files))],
        height, width, {0: [(3, intro)], 1: [(3, None)], 2: [(3, None)],
                        3: [(3, None)]}, device=device)


def t_postprocess_kwargs(files: dict) -> list[dict]:
    """Source 1: ``-d forward -f scale=1.5;clip=8``; source 2: a DSL
    ``--mask``, the ``--kernel`` and ``-f polar=r:a+0.1*t``."""
    return [dict(direction="forward", flow_filters=T_FILTERS[0]),
            dict(direction="backward", mask_path=T_FLOW_MASK,
                 kernel_path=files["kernel"], flow_filters=T_FILTERS[1])]


def run_t_engine(device, grays, files: dict) -> dict:
    """The Engine over two CvFlowConfig() sources (the gray frames of each
    pan, ``t_postprocess_kwargs``), ``--merge absmax`` and the four
    layers: a warm-up chunk, a timed chunk with its launches, then
    ``process_frame`` calls."""
    from transflow_tpu_torch.config import Config
    from transflow_tpu_torch.engine import Engine
    from transflow_tpu_torch.flow.sources.cv import CvFlowConfig
    sources = [frame_source(frames, CvFlowConfig(), **kwargs)
               for frames, kwargs in zip(grays,
                                         t_postprocess_kwargs(files))]
    params = t_layer_params(files, HEIGHT, WIDTH, device)
    engine = Engine(Config("synthetic", seed=SEED,
                           flows_merging_function="absmax"),
                    sources, params, HEIGHT, WIDTH, export_flows=True,
                    device=device)
    rng = np.random.default_rng(SEED)
    pixmaps = tuple((torch.from_numpy(rng.integers(
        0, 256, (HEIGHT, WIDTH, 3), dtype=np.uint8)).to(device),)
        for _ in params)
    slots = tuple((None,) for _ in params)
    items = [iter(source) for source in sources]

    def take(n):
        return [[next(it) for _ in range(n)] for it in items]

    warm = take(ENGINE_WARMUP)
    for runtime, its in zip(engine.runtimes, warm):
        runtime.reset(its[0].prime)
    engine.process_chunk([torch.stack([it.array for it in its])
                          for its in warm], pixmaps, slots, 0, 0)
    chunk = [torch.stack([it.array for it in its])
             for its in take(ENGINE_FRAMES)]
    torch.cuda.synchronize()
    _zero_launches()
    start = time.perf_counter()
    out, flows = engine.process_chunk(chunk, pixmaps, slots, ENGINE_WARMUP,
                                      ENGINE_WARMUP)
    finite = torch.isfinite(flows).all()
    sums = out.sum(dim=(1, 2, 3), dtype=torch.int64)
    finite, sums = finite.item(), sums.tolist()
    seconds = time.perf_counter() - start
    chunk_launches = _launches()

    def step(fno):
        return engine.process_frame([next(it) for it in items], pixmaps,
                                    fno / 30.0, tuple((fno,) for _ in params))

    fno0 = ENGINE_WARMUP + ENGINE_FRAMES
    call_flows = []
    for k in range(ENGINE_CALLS):
        frame, flow = step(fno0 + k)
        call_flows.append(flow)
    finite = finite and torch.isfinite(torch.stack(call_flows)).all().item()
    torch.cuda.synchronize()
    return {"ms": 1e3 * seconds / ENGINE_FRAMES, "out": out, "flows": flows,
            "finite": finite, "sums": sums, "chunk_launches": chunk_launches,
            "launches": _launches(), "engine": engine, "step": step,
            "next_fno": fno0 + ENGINE_CALLS}


def t_cli_argv(root: Path, files: dict) -> list[str]:
    """The CLI over the two PGM sequences with every option of the phase
    (the CLI gives both sources the same flow options)."""
    moves = ["--move-mask-source", T_MOVE_SRC, "--move-mask-destination",
             T_MOVE_DST]
    reset = ["-r", "random", "0.01", "-m", files["gradient"]]
    return [str(root / "a" / "%04d.pgm"), "--flow",
            str(root / "b" / "%04d.pgm"), "-d", "forward", "--mask",
            T_FLOW_MASK, "--kernel", files["kernel"], "-f",
            ";".join(T_FILTERS), "--merge", "absmax",
            "-l", "0", "introduction", "-e", "--mask-alpha", T_ALPHA[0],
            *moves,
            "-l", "1", "sum", "--mask-alpha", T_ALPHA[1], *moves, *reset,
            "-l", "2", "static", "--mask-alpha", T_ALPHA[2],
            "-l", "3", "moveref", "-e", "--mask-alpha", T_ALPHA[3], *moves,
            *reset,
            "-p", "noise", "0", "-i", T_INTRO_MASK, "-p", "gradient", "1",
            "2", "-p", "cnoise", "3", "--seed", str(SEED),
            "-o", str(root / "out" / "%04d.ppm")]


def t_twin(device, files_small: dict) -> dict:
    """At 128x192: the post-process chain of each source on the card and
    on the CPU over the same raw flows (source 2 within the CPU tests'
    convolution bound, source 1's filters within 4 ulps of the norm and
    B5 bit-equal on the same filtered flow), then the four-layer
    compositor on both devices over the CPU's merged flows, bit-equal."""
    from transflow_tpu_torch import prng
    from transflow_tpu_torch.compositor.core import build_compositor
    from transflow_tpu_torch.flow import Direction
    from transflow_tpu_torch.flow.filters import FlowFilter
    from transflow_tpu_torch.flow.merge import merge_absmax
    from transflow_tpu_torch.flow.transforms import make_postprocess
    from transflow_tpu_torch.ops.image import clip_to_frame
    from transflow_tpu_torch.ops.scatter import (forward_to_backward_cuda,
                                                 forward_to_backward_plain)
    from transflow_tpu_torch.utils import load_float_mask
    h, w = T_TWIN
    rng = np.random.default_rng(SEED)
    raws = [torch.from_numpy((rng.standard_normal((T_TWIN_FRAMES, h, w, 2))
                              * 4).astype(np.float32)) for _ in range(2)]
    kernel = np.load(files_small["kernel"])
    mask = load_float_mask(T_FLOW_MASK, (h, w))
    filters = FlowFilter.parse_many(T_FILTERS[0])
    merged, worst = [], {"conv": 0.0, "filter_ulps": 0, "b5": 0}
    for k in range(T_TWIN_FRAMES):
        t = np.float32(k / 30.0)
        outs = {}
        for dev in (device, "cpu"):
            f1 = raws[0][k].to(dev)
            for flt in filters:
                f1 = flt(f1, t)
            pp2 = make_postprocess(T_FILTERS[1], mask, kernel,
                                   Direction.BACKWARD, device=dev)
            outs[str(dev)] = (f1.cpu(), pp2(raws[1][k].to(dev), t).cpu())
        (c1, c2), (p1, p2) = outs[str(device)], outs["cpu"]
        scale = np.abs(kernel).sum() * raws[1][k].abs().max().item()
        worst["conv"] = max(worst["conv"],
                            (c2 - p2).abs().max().item() / scale)
        radius = np.linalg.norm(p1.numpy(), axis=-1, keepdims=True)
        ulps = np.abs(c1.numpy() - p1.numpy()) / np.spacing(
            np.maximum(radius, 1e-3).astype(np.float32))
        worst["filter_ulps"] = max(worst["filter_ulps"], float(ulps.max()))
        b5 = forward_to_backward_cuda(p1.to(device).contiguous()).cpu()
        want = forward_to_backward_plain(p1)
        worst["b5"] += int((b5 != want).sum())
        merged.append(merge_absmax([clip_to_frame(want), p2]))
    if worst["conv"] > 1e-5 or worst["filter_ulps"] > 4 or worst["b5"]:
        raise AssertionError(f"phase T twin: card against CPU {worst}")
    results = {}
    for dev in (device, "cpu"):
        params = t_layer_params(files_small, h, w, dev)
        init_fn, step_fn = build_compositor(params, h, w, device=dev)
        state = init_fn()
        pix = np.random.default_rng(SEED + 1).integers(0, 256, (h, w, 3),
                                                       np.uint8)
        pixmaps = tuple((torch.from_numpy(pix).to(dev),) for _ in params)
        key = prng.key(SEED)
        for k, flow in enumerate(merged):
            key, sub = prng.split(key)
            state, rgb = step_fn(state, flow.to(dev), pixmaps, sub,
                                 tuple((k,) for _ in params))
        results[str(dev)] = ([{n: v.cpu() for n, v in layer.items()}
                              for layer in state], rgb.cpu())
    (s_dev, rgb_dev), (s_cpu, rgb_cpu) = results[str(device)], results["cpu"]
    for idx, (a, b) in enumerate(zip(s_dev, s_cpu)):
        for name in b:
            if not torch.equal(a[name], b[name]):
                raise AssertionError(f"phase T twin: layer {idx} {name!r} "
                                     "differs between the card and the CPU")
    if not torch.equal(rgb_dev, rgb_cpu):
        raise AssertionError("phase T twin: compositor frames differ")
    return worst


def phase_postprocess(device, card: str) -> dict:
    """Phase T: the Engine at 1080x1920 over two Farneback sources with
    the forward direction, filters, a mask and a kernel, ``absmax`` and
    the four layer classes with their masks; then the CLI in process over
    the same options; then the 128x192 twin (``t_twin``). Returns the
    runs."""
    import tempfile
    from transflow_tpu_torch.utils.imageio import write_netpbm
    n = (1 + ENGINE_WARMUP + ENGINE_FRAMES + ENGINE_CALLS + T_SYNC_CALLS
         + T_PROFILE_CALLS)
    grays = [t_gray(n, pan, HEIGHT, WIDTH, device) for pan in T_PANS]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_t_") as tmp:
        root = Path(tmp)
        files = t_files(root, HEIGHT, WIDTH)
        run = run_t_engine(device, grays, files)
        per_frame = tuple(x / ENGINE_FRAMES for x in run["chunk_launches"])
        if run["chunk_launches"] != tuple(ENGINE_FRAMES * x
                                          for x in T_PER_FRAME):
            raise AssertionError(f"phase T: {KERNEL_NAMES} launches per "
                                 f"frame {per_frame}, expected "
                                 f"{T_PER_FRAME}")
        frames_run = ENGINE_FRAMES + ENGINE_CALLS
        if run["launches"] != tuple(frames_run * x for x in T_PER_FRAME):
            raise AssertionError(f"phase T: {run['launches']} launches over "
                                 f"{frames_run} frames")
        if not run["finite"] or run["out"].shape != (ENGINE_FRAMES, HEIGHT,
                                                     WIDTH, 3):
            raise AssertionError(f"phase T: finite {run['finite']}, frames "
                                 f"{tuple(run['out'].shape)}")
        print(f"postprocess engine {HEIGHT}x{WIDTH} two CvFlowConfig() "
              f"sources (pans {T_PANS}; -d forward -f {T_FILTERS[0]!r} | "
              f"--mask {T_FLOW_MASK} --kernel 5x5 -f {T_FILTERS[1]!r}) "
              "--merge absmax -> introduction, sum, static, moveref with "
              f"layer masks: {run['ms']:.2f} ms/frame "
              f"{1e3 / run['ms']:.2f} frames/s over a chunk of "
              f"{ENGINE_FRAMES}; launches per frame {per_frame} "
              f"{KERNEL_NAMES}; per-frame checksums {run['sums']}; on {card}")
        run["syncs"] = host_syncs(run, T_SYNC_CALLS)
        print(f"postprocess engine: {run['syncs']:g} host syncs per frame "
              f"(torch.cuda.set_sync_debug_mode, {T_SYNC_CALLS} "
              "process_frame calls)")
        if run["syncs"] != 0:
            raise AssertionError(f"phase T: {run['syncs']} host syncs per "
                                 "frame, expected 0")
        run["profile"] = engine_profile("postprocess engine", run,
                                        T_PROFILE_CALLS, card)
        # the forward flow Farneback gives on the pan: B5's main input
        run["b5_flow"] = run["engine"].runtimes[0].last_raw.contiguous()
        # the CLI in process over the same sequences and options
        for name, frames in zip("ab", grays):
            (root / name).mkdir()
            for i, frame in enumerate(frames[:T_CLI_FRAMES].cpu().numpy()):
                write_netpbm(str(root / name / f"{i:04d}.pgm"), frame)
        (root / "out").mkdir()
        cli_run = _p_run(t_cli_argv(root, files))
        flows_n = T_CLI_FRAMES - 1
        cli_per_frame = (*T_PER_FRAME[:6], 2 * T_PER_FRAME[6],
                         *T_PER_FRAME[7:])
        if cli_run["launches"] != tuple(flows_n * x for x in cli_per_frame):
            raise AssertionError(f"phase T CLI: {KERNEL_NAMES} launches "
                                 f"{cli_run['launches']}, expected "
                                 f"{cli_per_frame} per frame over {flows_n}")
        out = _p_frames(root / "out", flows_n)
        print(f"postprocess CLI {HEIGHT}x{WIDTH} (both sources -d forward, "
              f"--mask, --kernel, -f {';'.join(T_FILTERS)!r}, --merge "
              f"absmax, four layers): {_p_split(cli_run, flows_n)}; "
              f"launches per frame {cli_per_frame} {KERNEL_NAMES}; "
              f"{len(out)} frames, {len(np.unique(out[-1]))} distinct "
              "values in the last")
        run["cli_launches"] = cli_run["launches"]
        run["cli_fps"] = flows_n / cli_run["seconds"]
        (root / "twin").mkdir()
        files_small = t_files(root / "twin", *T_TWIN)
        worst = t_twin(device, files_small)
        print(f"postprocess twin {T_TWIN[0]}x{T_TWIN[1]} card vs CPU over "
              f"{T_TWIN_FRAMES} frames: source 2's chain within "
              f"{worst['conv']:.2e} of sum|k| max|flow| (bound 1e-5), source "
              f"1's filters within {worst['filter_ulps']:g} ulps of the norm "
              "(bound 4), B5 bit-equal, the four-layer compositor's states "
              "and frames bit-equal")
    return run


# phase H: the secondary estimators, Horn-Schunck and Lucas-Kanade, at 1080p
H_PRESETS = ("horn-schunck.json", "horn-schunck-diverge.json",
             "horn-schunck-smooth-inertia.json", "lukas-kanade.json",
             "lk16.json")
H_CLI_PRESETS = ("horn-schunck.json", "lukas-kanade.json")
H_LK_ITERS = 10       # lucas_kanade's iterations a level (no config knob)
H_SYNC_CALLS = 1
H_PROFILE_CALLS = 2   # process_frame calls under the profiler (phase 10)
H_CLI_FRAMES = 4      # PGM frames of each CLI run; 3 flows
H_STATIC_ITERS = 5    # max_iters of the static pair
# (H, W, name) of Lucas-Kanade's pyramid of a 1080p frame at the
# window and max_level of lukas-kanade.json (CvFlowConfig's defaults)
H_LK_WIN, H_LK_MAX_LEVEL = 15, 2
H_LK_LEVELS = ((1080, 1920, "L0"), (540, 960, "L1"), (270, 480, "L2"))
# float32 operations a pixel. B9: both frames' vertical and horizontal
# 5-tap blurs (each 5 products and 4 sums a pixel, whatever tile the
# kernel stages), the three 2x2 stencils of both and denom. B10: the
# eight-tap averages of u and v, c,
# the new u and v, the squared step. B11: the coordinates, the weights,
# three lerps, it and the products. B12: the vertical and horizontal sums
# of two planes (the tensor mode: three products and three planes), then
# the solve (the tensor mode: det and 1 / det).
B9_OPS = 2 * 2 * 9 + 2 * 3 * 7 + 5
B10_OPS = 2 * 15 + 11
B11_OPS = 6 + 9 + 3
B12_OPS = {"solve": 2 * 2 * 14 + 13, "tensor": 3 + 3 * 2 * 14 + 5}
# the CUDA kernel behind each of phase H's wrappers (profiler names)
H_KERNEL_NAMES = {"hs_derivatives": "hs_derivatives_kernel",
                  "hs_iterate": "hs_iterate_kernel",
                  "hs_iterate_copy": "hs_iterate_kernel",
                  "lk_warp_products": "lk_warp_products_kernel",
                  "lk_structure_tensor": "lk_window_kernel",
                  "lk_window_solve": "lk_window_kernel",
                  "lk_pyramid": "lk_pyramid_kernel",
                  "downsample2x": "lk_pyramid_kernel"}
# launches per 1080p frame of each of phase H's kernel rows on the main
# path: horn-schunck.json's 1 B9 and 3 B10; per Lucas-Kanade level 10 B11,
# 1 tensor and 10 solves of B12
H_PER_LEVEL = {"hs_derivatives": 1, "hs_iterate": 3,
               "lk_warp_products": H_LK_ITERS, "lk_structure_tensor": 1,
               "lk_window_solve": H_LK_ITERS}


def h_per_frame(config, height: int, width: int) -> tuple:
    """``KERNEL_NAMES`` launches per frame of a Horn-Schunck or
    Lucas-Kanade config at H x W: 1 B9 and ``max_iters`` B10; or per level
    of the pyramid (the estimator's rule, ``lk_shapes``: levels while the
    short side is at least twice the window) 10 B11 and 11 B12 (the
    tensor and 10 solves), and the whole pyramid's B14 launches, one up
    to two levels below L0 (``lk_launches``)."""
    from transflow_tpu_torch.ops import pyramid
    kw = config.estimator_kwargs()
    if config.method == "horn-schunck":
        return (0,) * 7 + (1, kw["max_iters"], 0, 0, *C_MOVEREF, 0, 0, 0, 0,
                           0, 0)
    levels = len(pyramid.lk_shapes(height, width, kw["win_size"],
                                   kw["max_level"]))
    return (0,) * 7 + (0, 0, H_LK_ITERS * levels, (H_LK_ITERS + 1) * levels,
                       *C_MOVEREF, 0, pyramid.lk_launches(levels), 0, 0,
                       0, 0)


def phase_classic_engine(device, card: str) -> dict:
    """Phase H: the 1080p Engine over each Horn-Schunck and Lucas-Kanade
    preset on phase F's pan (one moveref layer, random reset 0.01): the
    launches per frame, finite flows, 0 host syncs per frame, and for
    ``lukas-kanade.json`` every interior median within 0.5 px of the pan;
    then a static pair through Horn-Schunck (one iteration, read back once
    after the frame), then ``cli.main`` over PGM frames with each default
    preset. Returns the Engine runs by preset."""
    import tempfile
    from transflow_tpu_torch.flow.estimators.horn_schunck import (
        horn_schunck_counted)
    from transflow_tpu_torch.flow.sources.cv import CvFlowConfig
    from transflow_tpu_torch.ops.horn_schunck import hs_iterate_cuda
    from transflow_tpu_torch.utils.imageio import write_netpbm
    configs = Path(__file__).resolve().parent / "assets" / "configs"
    n = (1 + ENGINE_WARMUP + ENGINE_FRAMES + ENGINE_CALLS + H_SYNC_CALLS
         + H_PROFILE_CALLS)
    frames = gray_frames(n, HEIGHT, WIDTH, device)
    pixmap = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 256, (HEIGHT, WIDTH, 3), dtype=np.uint8)).to(device)
    runs = {}
    for name in H_PRESETS:
        config = CvFlowConfig.from_file(configs / name)
        run = run_engine(device, frames, pixmap, config)
        per_frame = h_per_frame(config, HEIGHT, WIDTH)
        _check_engine_run(f"phase H {name}", run, per_frame)
        m = FB_MARGIN
        inner = torch.cat([run["flows"], run["call_flows"]])[:, m:-m, m:-m]
        medians = inner.reshape(len(inner), -1, 2).median(dim=1).values
        worst = (medians - FB_PAN).abs().max().item()
        print(f"classic engine {HEIGHT}x{WIDTH} {name} ->moveref: "
              f"{run['ms']:.2f} ms/frame {1e3 / run['ms']:.2f} frames/s over "
              f"a chunk of {ENGINE_FRAMES} (max |flow| "
              f"{run['max_flow']:.4g}, checksum {run['checksum']}) on {card}")
        print(f"classic engine {name} launches per frame: "
              f"{_per_frame_text(run)}; interior median flow per frame "
              f"{[tuple(round(v, 3) for v in r) for r in medians.tolist()]} "
              f"(pan {FB_PAN}, worst |median - pan| {worst:.4f})")
        if name == "lukas-kanade.json" and not worst <= FB_PAN_TOL:
            raise AssertionError(f"phase H {name}: an interior median flow "
                                 f"is {worst} px from the {FB_PAN} px pan")
        run["syncs"] = host_syncs(run, H_SYNC_CALLS)
        print(f"classic engine {name}: {run['syncs']:g} host syncs per "
              f"frame (torch.cuda.set_sync_debug_mode, {H_SYNC_CALLS} "
              "process_frame call)")
        if run["syncs"] != 0:
            raise AssertionError(f"phase H {name}: {run['syncs']} host "
                                 "syncs per frame, expected 0")
        runs[name] = run
    # a static pair: the first step's norm is 0 < delta
    before = hs_iterate_cuda.launches
    flow, iters = horn_schunck_counted(frames[0], frames[0],
                                       max_iters=H_STATIC_ITERS)
    iters, moved = int(iters), bool(flow.any())
    print(f"classic static pair {HEIGHT}x{WIDTH} horn-schunck: {iters} "
          f"iteration taken of {H_STATIC_ITERS} "
          f"({hs_iterate_cuda.launches - before} B10 launches), flow "
          f"{'nonzero' if moved else 'zero'}")
    if iters != 1 or moved or hs_iterate_cuda.launches - before \
            != H_STATIC_ITERS:
        raise AssertionError(f"phase H static pair: {iters} iterations, "
                             f"flow moved {moved}")
    # the CLI with each default preset over PGM frames of the pan
    with tempfile.TemporaryDirectory(prefix="chip_smoke_h_") as tmp:
        root = Path(tmp)
        (root / "seq").mkdir()
        for i, frame in enumerate(frames[:H_CLI_FRAMES].cpu().numpy()):
            write_netpbm(str(root / "seq" / f"{i:04d}.pgm"), frame)
        flows_n = H_CLI_FRAMES - 1
        for name in H_CLI_PRESETS:
            out = root / name.split(".")[0]
            out.mkdir()
            cli_run = _p_run([str(root / "seq" / "%04d.pgm"), "-c",
                              str(configs / name), "-p", "noise", "--seed",
                              str(SEED), "-r", "random", "0.01", "-o",
                              str(out / "%04d.ppm")])
            want = h_per_frame(CvFlowConfig.from_file(configs / name),
                               HEIGHT, WIDTH)
            if cli_run["launches"] != tuple(flows_n * x for x in want):
                raise AssertionError(f"phase H CLI {name}: "
                                     f"{cli_run['launches']} launches, "
                                     f"expected {want} per frame over "
                                     f"{flows_n}")
            written = _p_frames(out, flows_n)
            print(f"classic CLI {HEIGHT}x{WIDTH} -c {name}: "
                  f"{_p_split(cli_run, flows_n)}; launches per frame "
                  f"{want} {KERNEL_NAMES}; {len(written)} frames, "
                  f"{len(np.unique(written[-1]))} distinct values in the "
                  "last")
    return runs


# phase V: video in (--mv) and out (-o x.mp4) through the libav shim
V_FRAMES = 24         # frames encoded; 23 flows
V_FPS = 25.0
V_CUT = "00:00:00.480"  # -t: 12 frames at 25 frames/s
V_CUT_FRAMES = 12
V_MARGIN = 64         # rows and columns left out of the dominant check


def phase_libav() -> bool:
    """The libav shim's line: loaded, or absent with the loader's error."""
    from transflow_tpu_torch import av_native
    if av_native.is_available():
        print(f"libav: loaded {av_native.LIB_PATH}")
        return True
    print(f"libav: absent: {av_native.load_error()}")
    return False


def phase_video(device, card: str) -> dict:
    """Phase V: 24 frames at 1080x1920 (phase F's texture panned 3 px a
    frame) encoded by the port's ``H264Writer`` (bf 0, refs 1); every
    interior motion-vector field's dominant value must be the pan, and
    the rasterization is timed a frame; then ``cli.main([clip, "--mv",
    "-p", "noise", "--seed", "0", "-o", out.mp4])`` on the card, whose
    ``out.mp4`` must reopen through ``MvReader`` at 1080x1920 with 23
    frames, and the same cut to 12 frames (``-t``), whose host syncs
    against the full run's give the syncs a frame adds (must be 0)."""
    import tempfile
    from transflow_tpu_torch import av_native
    from transflow_tpu_torch.flow.sources.mv import rasterize
    flows_n = V_FRAMES - 1
    pan = (-float(FB_PAN), -float(FB_PAN))  # the field is -motion
    frames = panned_frames(V_FRAMES, HEIGHT, WIDTH, device).cpu().numpy()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_v_") as tmp:
        root = Path(tmp)
        clip = str(root / "clip.mp4")
        start = time.perf_counter()
        with av_native.H264Writer(clip, WIDTH, HEIGHT, V_FPS) as writer:
            for frame in frames:
                writer.feed(frame)
        encode_ms = 1e3 * (time.perf_counter() - start) / V_FRAMES
        raster_ms, records, m = [], 0, V_MARGIN
        with av_native.MvReader(clip) as reader:
            reader.next()  # the IDR: no vectors
            while (vectors := reader.next()) is not None:
                start = time.perf_counter()
                field = rasterize(vectors, reader.height, reader.width)
                raster_ms.append(1e3 * (time.perf_counter() - start))
                records += len(vectors)
                values, counts = np.unique(field[m:-m, m:-m].reshape(-1, 2),
                                           axis=0, return_counts=True)
                dominant = tuple(values[np.argmax(counts)].tolist())
                if dominant != pan:
                    raise AssertionError(
                        f"phase V: field {len(raster_ms)}'s dominant value "
                        f"{dominant}, expected the pan {pan}")
        if len(raster_ms) != flows_n:
            raise AssertionError(f"phase V: {len(raster_ms)} fields, "
                                 f"expected {flows_n}")
        print(f"video {HEIGHT}x{WIDTH}: {V_FRAMES} frames encoded by "
              f"H264Writer (libx264, bf 0, refs 1) at {encode_ms:.2f} "
              f"ms/frame; {records / flows_n:.0f} motion vectors a frame; "
              f"every interior field's dominant value {pan}; rasterization "
              f"{statistics.median(raster_ms):.3f} ms/frame (median, host; "
              f"min {min(raster_ms):.3f}, max {max(raster_ms):.3f})")

        def argv(out: str, *extra: str) -> list[str]:
            return [clip, "--mv", "-p", "noise", "--seed", str(SEED), "-o",
                    str(root / out), *extra]

        run = _p_run(argv("out.mp4"), count_syncs=True)
        if run["pipeline"].engine.device != device:
            raise AssertionError(f"phase V: the Engine ran on "
                                 f"{run['pipeline'].engine.device}")
        cut = _p_run(argv("cut.mp4", "-t", V_CUT), count_syncs=True)
        syncs = (run["syncs"] - cut["syncs"]) / (flows_n - V_CUT_FRAMES)
        for name, n in (("out.mp4", flows_n), ("cut.mp4", V_CUT_FRAMES)):
            with av_native.MvReader(str(root / name)) as reader:
                count = 0
                while reader.next() is not None:
                    count += 1
                got = (reader.height, reader.width, reader.frame_count,
                       count)
            if got != (HEIGHT, WIDTH, n, n):
                raise AssertionError(f"phase V: {name} reopens as (H, W, "
                                     f"frame_count, frames read) {got}, "
                                     f"expected {n} frames")
        print(f"video CLI {HEIGHT}x{WIDTH} --mv -o out.mp4 {flows_n} frames: "
              f"{_p_split(run, flows_n)}; out.mp4 reopens as {HEIGHT}x"
              f"{WIDTH}, {flows_n} frames; launches {run['launches']} "
              f"{KERNEL_NAMES}; host syncs {run['syncs']} against "
              f"{cut['syncs']} for the {V_CUT_FRAMES}-frame cut: {syncs:g} "
              f"a frame after the warm-up; on {card}")
        if syncs != 0:
            raise AssertionError(f"phase V: {syncs} host syncs a frame")
    return {"fps": flows_n / run["seconds"], "raster_ms": raster_ms}


# phase S: two streams through the stream mesh (sharded_scan)
S_PANS = (3, -3)
S_CHUNK = 8
S_CHUNKS = 2          # chunks held to each stream's lone model.scan
S_SYNC_CALLS = 2      # one-frame calls that count the host's syncs
S_PROFILE_CALLS = 4   # one-frame calls under the profiler (phase 10)
S_ITERS = 8
S_RESET = 0.05
S_HALO = 8
S_TOOL_FRAMES = 9     # frames of each sequence the batch renderer reads
S_PER_FRAME = (0, 0, 0, 0, 0, 0, 0, 1, S_ITERS, 0, 0,
               *C_MOVEREF, 0, 0, 0, 0, 0, 0)  # a stream-frame


def s_model(device, halo: int | None = None):
    """The batch renderer's model (tools/batch_render.py) at 1080x1920:
    Horn-Schunck with ``max_iters=8, delta=None``, one moveref layer with
    random reset 0.05, ``clip=halo`` where a halo is given."""
    from transflow_tpu_torch.config import LayerConfig
    from transflow_tpu_torch.flow import Direction
    from transflow_tpu_torch.model import FlowTransferModel
    return FlowTransferModel(
        HEIGHT, WIDTH,
        [LayerConfig(0, reset_mode="random", reset_random_factor=S_RESET,
                     reset_linear_factor=S_RESET,
                     reset_constant_step=S_RESET)],
        {0: [(3, np.ones((HEIGHT, WIDTH), bool))]}, method="horn-schunck",
        estimator_kwargs=dict(max_iters=S_ITERS, delta=None),
        direction=Direction.BACKWARD,
        flow_filters=f"clip={halo}" if halo else None, halo=halo,
        device=device)


def s_chunks(run, model, grays, pixmaps, keys, chunks: int,
             timed: int | None = None, barrier=None) -> dict:
    """``run`` (a ``sharded_scan``) over ``chunks`` chunks of S_CHUNK
    frames from frame 1 with the batch renderer's keys (``fold_in(k,
    start)``); chunk ``timed`` is timed (host clock to a synchronize,
    after ``barrier()`` where one is given) and its launches counted from
    0. A stream whose frames are None is another process's. Returns the
    state, each stream's frames (None for another process's) and the
    timed chunk's ms, launches and wall-clock start and end."""
    from transflow_tpu_torch import prng
    state = [None if g is None else model.init_state(g[0]) for g in grays]
    outs = [[] for _ in grays]
    result = {}
    for c in range(chunks):
        start = 1 + c * S_CHUNK
        args = ([None if g is None else g[start:start + S_CHUNK]
                 for g in grays], pixmaps, (start - 1) / model.framerate,
                [prng.fold_in(k, start) for k in keys])
        if c == timed:
            torch.cuda.synchronize()
            if barrier is not None:
                barrier()
            _zero_launches()
            result["wall"] = [time.time()]
            t0 = time.perf_counter()
            state, rgbs = run(state, *args)
            torch.cuda.synchronize()
            result["ms"] = 1e3 * (time.perf_counter() - t0)
            result["wall"].append(time.time())
            result["launches"] = _launches()
        else:
            state, rgbs = run(state, *args)
        for s, rgb in enumerate(rgbs):
            if rgb is not None:
                outs[s].append(rgb)
    result.update(state=state,
                  frames=[torch.cat(o) if o else None for o in outs])
    return result


def lone_scan(model):
    """``model.scan`` of one stream in ``s_chunks``' form."""
    def run(state, grays, pixmaps, t0, keys):
        state, rgb = model.scan(state[0], grays[0], pixmaps[0], t0, keys[0])
        return [state], [rgb]
    return run


def phase_streams(device, card: str) -> dict:
    """Phase S: two 1080x1920 streams (pans of +3 and -3 px, their own
    random pixmaps) through ``sharded_scan(..., per_stream_pixmaps=True)``
    over ``make_mesh(devices=[card] * 2, stream_axis=2)``, two chunks of
    8: 1 B9 + 8 B10 launches a stream-frame, each stream bit-equal to its
    own ``model.scan`` alone; the host syncs a frame of one-frame calls
    after them; then stream 2 x space 2 (``[card] * 4``) with ``halo=8``
    and ``clip=8`` against the same without the space axis (flows within
    1e-5, frames bit-equal); then the batch renderer
    (``transflow_tpu_torch.tools.batch_render``) over two 9-frame PGM
    sequences, its ``%04d`` frames equal to the first chunk, and its MP4s
    where the libav shim loads. Returns the one-frame stepping run for the
    profile and the launches."""
    import tempfile
    from transflow_tpu_torch import av_native, prng
    from transflow_tpu_torch.parallel import make_mesh, sharded_scan
    from transflow_tpu_torch.tools import batch_render
    from transflow_tpu_torch.utils.imageio import read_netpbm, write_netpbm
    n = 1 + S_CHUNKS * S_CHUNK + S_SYNC_CALLS + S_PROFILE_CALLS
    grays = [t_gray(n, pan, HEIGHT, WIDTH, device) for pan in S_PANS]
    pix_np = [np.random.default_rng(SEED + s).integers(
        0, 256, (HEIGHT, WIDTH, 3), dtype=np.uint8) for s in range(2)]
    pixmaps = [((torch.from_numpy(p).to(device),),) for p in pix_np]
    keys = prng.split(prng.key(SEED), 2)
    model = s_model(device)
    mesh = make_mesh(devices=[device] * 2, stream_axis=2)
    run = sharded_scan(model, mesh, per_stream_pixmaps=True)
    main = s_chunks(run, model, grays, pixmaps, keys, S_CHUNKS, timed=1)
    frames_n = 2 * S_CHUNK  # stream-frames of the timed chunk
    per_frame = tuple(x / frames_n for x in main["launches"])
    if per_frame != S_PER_FRAME:
        raise AssertionError(f"phase S: {KERNEL_NAMES} launches a "
                             f"stream-frame {per_frame}, expected "
                             f"{S_PER_FRAME}")

    for s in range(2):  # each stream alone, the same keys and pixmap
        alone = s_chunks(lone_scan(model), model, [grays[s]], [pixmaps[s]],
                         [keys[s]], S_CHUNKS)
        if not torch.equal(main["frames"][s], alone["frames"][0]):
            raise AssertionError(f"phase S: stream {s} differs from its "
                                 "lone model.scan")
    if torch.equal(main["frames"][0], main["frames"][1]):
        raise AssertionError("phase S: the two streams rendered alike")
    ms = main["ms"] / frames_n
    print(f"streams {mesh} 2 x {HEIGHT}x{WIDTH} horn-schunck max_iters="
          f"{S_ITERS} ->moveref (random {S_RESET}): {main['ms']:.2f} ms for "
          f"a chunk of {S_CHUNK} frames of both streams, {ms:.3f} ms a "
          f"stream-frame, {2 * ms:.3f} ms a frame of both; launches a "
          f"stream-frame B9 {per_frame[7]:g}, B10 {per_frame[8]:g}; each "
          f"stream bit-equal to its lone model.scan over {S_CHUNKS} chunks; "
          f"on {card}")
    # one-frame calls after the chunks: host syncs, then (phase 10) the
    # profile
    cursor = {"state": main["state"], "start": 1 + S_CHUNKS * S_CHUNK}

    def step(_fno):
        start = cursor["start"]
        cursor["state"], _ = run(
            cursor["state"], [g[start:start + 1] for g in grays], pixmaps,
            (start - 1) / model.framerate,
            [prng.fold_in(k, start) for k in keys])
        cursor["start"] = start + 1

    srun = {"next_fno": 0, "step": step}
    syncs = host_syncs(srun, S_SYNC_CALLS) / 2
    print(f"streams: {syncs:g} host syncs a stream-frame "
          f"(torch.cuda.set_sync_debug_mode, {S_SYNC_CALLS} one-frame "
          "calls)")
    if syncs != 0:
        raise AssertionError(f"phase S: {syncs} host syncs a stream-frame")
    # stream 2 x space 2 with the bounded gather, against no space axis
    halo_model = s_model(device, S_HALO)
    flat = s_chunks(sharded_scan(halo_model, mesh, True), halo_model, grays,
                    pixmaps, keys, S_CHUNKS)
    mesh4 = make_mesh(devices=[device] * 4, stream_axis=2)
    run4 = sharded_scan(halo_model, mesh4, per_stream_pixmaps=True)
    sharded = s_chunks(run4, halo_model, grays, pixmaps, keys, S_CHUNKS,
                       timed=1)
    diff = max((a["prev_flow"] - b["prev_flow"]).abs().max().item()
               for a, b in zip(sharded["state"], flat["state"]))
    same = all(torch.equal(a, b)
               for a, b in zip(sharded["frames"], flat["frames"]))
    print(f"streams {mesh4} halo={S_HALO} clip={S_HALO}: "
          f"{sharded['ms'] / frames_n:.3f} ms a stream-frame; launches a "
          f"stream-frame {tuple(x / frames_n for x in sharded['launches'])}"
          f" {KERNEL_NAMES}; against stream 2 x space 1: max |dflow| "
          f"{diff:.3e}, frames {'bit-equal' if same else 'DIFFER'}")
    if not diff <= MESH_FLOW_ATOL or not same:
        raise AssertionError(f"phase S: stream 2 x space 2 differs from "
                             f"space 1 (flow {diff}, frames equal {same})")
    # the batch renderer over two PGM sequences of the streams
    with tempfile.TemporaryDirectory(prefix="chip_smoke_s_") as tmp:
        root = Path(tmp)
        pairs = []
        for s in range(2):
            (root / f"f{s}").mkdir()
            for i, frame in enumerate(
                    grays[s][:S_TOOL_FRAMES].cpu().numpy()):
                write_netpbm(str(root / f"f{s}" / f"{i:04d}.pgm"), frame)
            write_netpbm(str(root / f"pix{s}.ppm"), pix_np[s])
            pairs.append((str(root / f"f{s}" / "%04d.pgm"),
                          str(root / f"pix{s}.ppm")))
        start = time.perf_counter()
        paths = batch_render.batch_render(
            pairs, str(root / "out"), chunk=S_CHUNK, seed=SEED,
            output="s{stream:02d}/%04d.ppm", mesh=mesh)
        tool_s = time.perf_counter() - start
        flows_n = S_TOOL_FRAMES - 1
        for s, path in enumerate(paths):
            got = np.stack([read_netpbm(path % i) for i in range(flows_n)])
            if not np.array_equal(got, main["frames"][s][:flows_n].cpu()
                                  .numpy()):
                raise AssertionError(f"phase S: the batch renderer's stream "
                                     f"{s} differs from sharded_scan's")
        text = "%04d.ppm frames"
        if av_native.is_available():
            mp4s = batch_render.batch_render(pairs, str(root / "mp4"),
                                             chunk=S_CHUNK, seed=SEED,
                                             mesh=mesh)
            for path in mp4s:
                with av_native.MvReader(path) as reader:
                    count = 0
                    while reader.next() is not None:
                        count += 1
                    got = (reader.height, reader.width, count)
                if got != (HEIGHT, WIDTH, flows_n):
                    raise AssertionError(f"phase S: {path} reopens as "
                                         f"{got}")
            text += f" and MP4s ({', '.join(Path(p).name for p in mp4s)}, " \
                    f"{flows_n} frames each)"
        print(f"streams batch renderer: 2 x {S_TOOL_FRAMES} PGM frames at "
              f"{HEIGHT}x{WIDTH} in {tool_s:.2f} s to {text}, each stream's "
              "frames equal to sharded_scan's first chunk")
    return {"step_run": srun, "launches": main["launches"]}


# phase M: the global stream x space mesh across two processes (gloo)
M_PROCESSES = 2
M_PANS = (3, -3, 2, -2)  # a stream each: 0-1 on process 0, 2-3 on process 1
M_SPACE = 2              # the devices a process gives, [card] * 2: one row
M_TIMEOUT = 300          # seconds: a worker's collectives, and the wait
M_A2_LEVEL = "L3"        # the LiteFlowNet level (stride 2) A2 runs on a row
M_RESULT = "multihost-result "  # the start of a worker's result line
# a stream-frame: phase S's, but the row's space axis splits the movement
# (halo 8), so the moveref layer updates through its plain ops
M_PER_FRAME = (*S_PER_FRAME[:11], *C_MESH, *S_PER_FRAME[14:])


def m_inputs(device, streams) -> tuple[list, list, list]:
    """Phase M's inputs, made from the seed in each process: the frames
    and pixmap of each stream in ``streams`` (None for the others), and
    every stream's key."""
    from transflow_tpu_torch import prng
    n = 1 + S_CHUNKS * S_CHUNK + S_SYNC_CALLS + S_PROFILE_CALLS
    grays = [t_gray(n, pan, HEIGHT, WIDTH, device) if s in streams else None
             for s, pan in enumerate(M_PANS)]
    pixmaps = [((torch.from_numpy(np.random.default_rng(SEED + s).integers(
        0, 256, (HEIGHT, WIDTH, 3), dtype=np.uint8)).to(device),),)
        if s in streams else None for s in range(len(M_PANS))]
    return grays, pixmaps, prng.split(prng.key(SEED), len(M_PANS))


def frames_digest(frames: torch.Tensor) -> str:
    return hashlib.sha256(frames.cpu().numpy().tobytes()).hexdigest()


def run_workers(commands: list[list[str]], timeout: float) -> list[str]:
    """Start every command at once and wait for all; returns each one's
    standard output. Where one exits non-zero, or any is still running
    after ``timeout`` seconds, all are killed at once and this raises with
    the end of each one's output."""
    import tempfile
    logs = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
            for _ in commands]
    procs = [subprocess.Popen(cmd, stdout=out, stderr=err, text=True)
             for cmd, (out, err) in zip(commands, logs)]
    deadline = time.monotonic() + timeout
    try:
        codes = [p.poll() for p in procs]
        while None in codes and not any(codes) and \
                time.monotonic() < deadline:
            time.sleep(0.1)
            codes = [p.poll() for p in procs]
        late = None in codes and not any(codes)
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
    outputs = []
    for out, err in logs:
        out.seek(0)
        err.seek(0)
        outputs.append((out.read(), err.read()))
        out.close()
        err.close()
    if late or any(p.returncode for p in procs):
        raise AssertionError(
            (f"workers still running after {timeout} s: " if late else "")
            + "; ".join(f"worker {k} exited {p.returncode}:\n"
                        f"{outputs[k][0][-2000:]}{outputs[k][1][-4000:]}"
                        for k, p in enumerate(procs)))
    return [out for out, _ in outputs]


def multihost_worker(rank: int, port: int, device=None) -> int:
    """One process of phase M: joins the gloo group on 127.0.0.1:``port``
    as ``rank`` of M_PROCESSES, builds the global mesh over ``[device] *
    M_SPACE`` (the card by default), checks its layout and an
    all-reduce, runs its two streams through ``sharded_scan``, counts
    their launches and host syncs, profiles one-frame calls, holds A2 on
    its row to A1, and prints its figures and a result line."""
    import torch.distributed as dist
    from transflow_tpu_torch import prng
    from transflow_tpu_torch.ops.correlation import (correlation,
                                                     sharded_correlation7x7)
    from transflow_tpu_torch.parallel import (RemoteRow, SpaceMesh,
                                              initialize, make_global_mesh,
                                              sharded_scan)
    device = torch.device("cuda", 0) if device is None else \
        torch.device(device)
    card = card_line()
    initialize(f"127.0.0.1:{port}", M_PROCESSES, rank, timeout=M_TIMEOUT)
    try:
        mesh = make_global_mesh(space_axis=M_SPACE,
                                devices=[device] * M_SPACE)
        if (mesh.shape != {"stream": M_PROCESSES, "space": M_SPACE}
                or mesh.processes != tuple(range(M_PROCESSES))
                or mesh.process != rank
                or not all(isinstance(row, SpaceMesh if owner == rank
                                      else RemoteRow)
                           for row, owner in zip(mesh.rows,
                                                 mesh.processes))):
            raise AssertionError(f"phase M: process {rank}'s mesh {mesh}")
        # an all-reduce across the processes of a sharded tensor's sum
        base = torch.arange(M_PROCESSES * 16 * 8, dtype=torch.float32
                            ).reshape(M_PROCESSES, 16, 8)
        total = torch.stack([(2.0 * band).sum() for band in mesh.rows[
            rank].split(base[rank].to(device))]).sum().reshape(1).cpu()
        dist.all_reduce(total)
        if total.item() != 2.0 * base.sum().item():
            raise AssertionError(f"phase M: process {rank}'s all-reduced "
                                 f"total {total.item()}")
        n = len(M_PANS)
        mine = [s for s in range(n) if mesh.is_local(s, n)]
        grays, pixmaps, keys = m_inputs(device, set(mine))
        model = s_model(device, S_HALO)
        run = sharded_scan(model, mesh, per_stream_pixmaps=True)
        main = s_chunks(run, model, grays, pixmaps, keys, S_CHUNKS, timed=1,
                        barrier=dist.barrier)
        frames_n = len(mine) * S_CHUNK
        per_frame = tuple(x / frames_n for x in main["launches"])
        digests = {s: frames_digest(main["frames"][s]) for s in mine}
        # one-frame calls after the chunks: host syncs, then the profile
        cursor = {"state": main["state"], "start": 1 + S_CHUNKS * S_CHUNK}

        def step(_fno):
            start = cursor["start"]
            cursor["state"], _ = run(
                cursor["state"],
                [None if g is None else g[start:start + 1] for g in grays],
                pixmaps, (start - 1) / model.framerate,
                [prng.fold_in(k, start) for k in keys])
            cursor["start"] = start + 1

        srun = {"next_fno": 0, "step": step}
        syncs = host_syncs(srun, S_SYNC_CALLS) / len(mine)
        dist.barrier()
        profile = engine_profile(
            f"multihost process {rank}, a frame of its {len(mine)} streams",
            srun, S_PROFILE_CALLS, card, "one-frame sharded_scan calls")
        # A2 on this process's space row against A1 on the whole tensor
        h, w, c, stride, level = next(x for x in CORR_SHAPES
                                      if x[4] == M_A2_LEVEL)
        t1, t2 = MAIN_PAIR[level]
        gen = torch.Generator(device=device).manual_seed(SEED + 1)
        f1 = torch.randn((h, w, c), generator=gen, device=device).to(t1)
        f2 = torch.randn((h, w, c), generator=gen, device=device).to(t2)
        before = sharded_correlation7x7.launches
        a2 = sharded_correlation7x7(f1, f2, mesh.rows[rank], stride)
        a2_launches = sharded_correlation7x7.launches - before
        a2_equal = torch.equal(a2, correlation(f1, f2, stride))
        result = {"rank": rank, "streams": mine, "digests": digests,
                  "ms": main["ms"], "wall": main["wall"],
                  "launches": main["launches"], "per_frame": per_frame,
                  "syncs": syncs, "busy_ms": profile["busy_ms"],
                  "wall_ms": profile["wall_ms"],
                  "a2": [level, h, w, c, stride, a2_launches, a2_equal]}
        gathered: list = [None] * M_PROCESSES
        dist.all_gather_object(gathered, result)
        result["gathered"] = gathered
        print(f"multihost process {rank}: {mesh}, streams {mine}, "
              f"{main['ms'] / frames_n:.3f} ms a stream-frame, launches a "
              f"stream-frame {per_frame} {KERNEL_NAMES}, {syncs:g} host "
              f"syncs a stream-frame; A2 at {level} over its row "
              f"{'bit-equal' if a2_equal else 'DIFFERS'} to A1 "
              f"({a2_launches} launch); on {card}", flush=True)
        print(M_RESULT + json.dumps(result), flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def phase_multihost(device, card: str) -> dict:
    """Phase M: four 1080x1920 streams (pans of +3, -3, +2 and -2 px,
    their own pixmaps) of phase S's model with ``halo=8`` and ``clip=8``
    through ``sharded_scan`` on the global mesh of two processes
    (``multihost_worker``, gloo on 127.0.0.1), stream 2 x space 2, two
    streams a process, two chunks of 8: each process 1 B9 + 8 B10 and 0
    host syncs a stream-frame, each stream's frames bit-equal to its lone
    ``model.scan`` in this process (digests gathered with
    ``all_gather_object``), A2 on each row bit-equal to A1. Prints ms a
    stream-frame for each process and for both, beside the same four
    streams through phase S's single-process ``sharded_scan`` (stream 2 x
    space 2, this process), and the busy time and idle share a
    stream-frame. Returns the launches of both processes' timed chunks."""
    from transflow_tpu_torch.parallel import (SpaceMesh, make_mesh,
                                              sharded_scan)
    n = len(M_PANS)
    grays, pixmaps, keys = m_inputs(device, set(range(n)))
    model = s_model(device, S_HALO)
    # one process: the four streams on the same layout, then each alone
    mesh = make_mesh(devices=[device] * (2 * M_SPACE), stream_axis=2)
    single = s_chunks(sharded_scan(model, mesh, True), model, grays,
                      pixmaps, keys, S_CHUNKS, timed=1)
    single_ms = single["ms"] / (n * S_CHUNK)
    row_model = model.replica(mesh=SpaceMesh([device] * M_SPACE),
                              device=device)
    want = {}
    for s in range(n):
        alone = s_chunks(lone_scan(row_model), row_model, [grays[s]],
                         [pixmaps[s]], [keys[s]], S_CHUNKS)
        if not torch.equal(alone["frames"][0], single["frames"][s]):
            raise AssertionError(f"phase M: stream {s}'s lone model.scan "
                                 "differs from the single-process "
                                 "sharded_scan")
        want[str(s)] = frames_digest(alone["frames"][0])
    del grays, pixmaps, single, alone
    torch.cuda.synchronize()
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    script = str(Path(__file__).resolve())
    start = time.perf_counter()
    outputs = run_workers(
        [[sys.executable, script, "--multihost-worker", str(rank), str(port)]
         for rank in range(M_PROCESSES)], M_TIMEOUT + 60)
    seconds = time.perf_counter() - start
    results = []
    for rank, out in enumerate(outputs):
        for line in out.splitlines():
            if line.startswith(M_RESULT):
                results.append(json.loads(line[len(M_RESULT):]))
            else:
                print(f"  [process {rank}] {line}")
    if [r["rank"] for r in results] != list(range(M_PROCESSES)):
        raise AssertionError(f"phase M: results of {len(results)} workers")
    for r in results:
        if [g["digests"] for g in r["gathered"]] != \
                [g["digests"] for g in results[0]["gathered"]]:
            raise AssertionError("phase M: the processes gathered "
                                 "different digests")
        if tuple(r["per_frame"]) != M_PER_FRAME or r["syncs"] != 0:
            raise AssertionError(
                f"phase M: process {r['rank']} launches a stream-frame "
                f"{r['per_frame']}, expected {M_PER_FRAME}; host syncs a "
                f"stream-frame {r['syncs']}")
        if not r["a2"][-1] or r["a2"][-2] != 1:
            raise AssertionError(f"phase M: process {r['rank']}'s A2 "
                                 f"{r['a2']} (bit-equal to A1, one launch)")
    got = {s: d for g in results[0]["gathered"]
           for s, d in g["digests"].items()}
    if got != want:
        raise AssertionError(
            "phase M: streams " + ", ".join(
                s for s in want if got.get(s) != want[s])
            + " differ from their lone model.scan")
    frames_n = [len(r["streams"]) * S_CHUNK for r in results]
    both_ms = 1e3 * (max(r["wall"][1] for r in results)
                     - min(r["wall"][0] for r in results)) / sum(frames_n)
    each = ", ".join(f"process {r['rank']} {r['ms'] / k:.3f}"
                     for r, k in zip(results, frames_n))
    print(f"multihost {M_PROCESSES} processes (gloo, 127.0.0.1) x [card] * "
          f"{M_SPACE}, stream {M_PROCESSES} x space {M_SPACE}, {n} x "
          f"{HEIGHT}x{WIDTH} horn-schunck max_iters={S_ITERS} halo={S_HALO} "
          f"clip={S_HALO}: ms a stream-frame {each}, both together "
          f"{both_ms:.3f} (a chunk of {S_CHUNK} frames, wall clock across "
          f"the processes), one process (sharded_scan, stream 2 x space "
          f"{M_SPACE}) {single_ms:.3f}; launches a stream-frame B9 "
          f"{S_PER_FRAME[7]:g}, B10 {S_PER_FRAME[8]:g} and 0 host syncs in "
          f"each process; each stream bit-equal to its lone model.scan "
          f"over {S_CHUNKS} chunks; A2 at {M_A2_LEVEL} over each row "
          f"bit-equal to A1; {seconds:.1f} s with the processes' start; "
          f"on {card}")
    # the card time-slices the two processes: its busy time is the sum
    busy = sum(r["busy_ms"] for r in results)
    wall = max(r["wall_ms"] for r in results)
    per = sum(len(r["streams"]) for r in results)
    print(f"multihost per stream-frame (torch.profiler in each process, "
          f"{S_PROFILE_CALLS} one-frame calls at once): " + ", ".join(
              f"process {r['rank']} {r['busy_ms'] / len(r['streams']):.3f} "
              f"ms busy of {r['wall_ms'] / len(r['streams']):.3f} ms host "
              f"clock" for r in results)
          + f"; the card {busy / per:.3f} ms busy of {wall / per:.3f}, idle "
          f"{1 - busy / wall:.1%} on {card}")
    return {"launches": tuple(sum(x) for x in zip(
        *(r["launches"] for r in results))), "both_ms": both_ms,
        "single_ms": single_ms}


# phase G: live tuning, the cv2 video input and the MJPEG preview, the GUI
G_BEFORE = 4          # process_frame calls before the change
G_AFTER = 4           # calls from the change on (the first rebuilds)
G_ITERATIONS = "5"    # fb_iterations as the window's widget sends it
# B1, B2a, B2b, B8 before and after
G_PER_FRAME = ((4, 12, 12, 1), (4, 20, 20, 1))
G_FRAMES = 24         # frames of the cv2-written clip; 23 flows
G_FPS = 25.0
G_CUT = "00:00:00.480"  # -t: 12 frames at the clip's 25 frames/s
G_CUT_FRAMES = 12
G_GUI_CUT = "00:00:00.360"  # the GUI job's 9 frames
G_GUI_FRAMES = 9
G_TIMEOUT = 120       # seconds for any socket or websocket wait


def _free_port() -> int:
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def g_live_tuning(device, card: str) -> dict:
    """G1: phase F's ``CvFlowConfig()`` Engine at 1080x1920 on the 3 px
    pan, ``G_BEFORE`` frames through ``process_frame``, then
    ``CvFlowConfigWindow(config).apply_value("fb_iterations", "5")`` (no
    window opened) and ``G_AFTER`` frames more: one estimator rebuild, on
    the first frame after the change; B1/B2a/B2b launches a frame
    ``G_PER_FRAME``; 0 host syncs a frame after the rebuild frame; the
    raw flow of the rebuild frame bit-equal to ``farneback`` with the new
    ``estimator_kwargs()`` on the same pair and warm start."""
    import warnings
    from transflow_tpu_torch.flow.estimators.farneback import farneback
    from transflow_tpu_torch.flow.sources.cv import CvFlowConfig
    from transflow_tpu_torch.gui.tuning import CvFlowConfigWindow
    config = CvFlowConfig()
    frames = gray_frames(1 + G_BEFORE + G_AFTER, HEIGHT, WIDTH, device)
    pixmap = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 256, (HEIGHT, WIDTH, 3), dtype=np.uint8)).to(device)
    engine, source = make_engine(device, frames, config)
    runtime = engine.runtimes[0]
    items = iter(source)
    pixmaps = ((pixmap,),)
    launches, ms, rebuilt, syncs = [], [], [], 0
    want = None
    for k in range(G_BEFORE + G_AFTER):
        if k == G_BEFORE:
            if not CvFlowConfigWindow(config).apply_value("fb_iterations",
                                                          G_ITERATIONS):
                raise AssertionError("G1: apply_value refused "
                                     f"fb_iterations={G_ITERATIONS!r}")
            prev_gray = runtime.prev_gray.clone()
            prev_flow = runtime.prev_flow.clone()
        item = next(items)
        step = runtime.estimator_step
        torch.cuda.synchronize()
        _zero_launches()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            count = k > G_BEFORE
            if count:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                start = time.perf_counter()
                engine.process_frame([item], pixmaps, k / G_FPS, ((k,),))
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - start))
        if count:
            syncs += sum("synchroniz" in str(w.message) for w in caught)
        launches.append(fb_launches(_launches()))
        rebuilt.append(runtime.estimator_step is not step)
        if k == G_BEFORE:
            want = farneback(item.array, prev_gray, prev_flow,
                             **config.estimator_kwargs())
            got = runtime.last_raw
    per_frame = [G_PER_FRAME[k >= G_BEFORE] for k in range(len(launches))]
    if sum(rebuilt) != 1 or not rebuilt[G_BEFORE]:
        raise AssertionError(f"G1: estimator rebuilt at frames {rebuilt}; "
                             f"expected once, at frame {G_BEFORE}")
    if launches != per_frame:
        raise AssertionError(f"G1: {FB_NAMES} launches a frame "
                             f"{launches}, expected {per_frame}")
    if syncs:
        raise AssertionError(f"G1: {syncs} host syncs after the rebuild "
                             "frame")
    if config.estimator_kwargs()["iterations"] != int(G_ITERATIONS) \
            or not torch.equal(got, want):
        raise AssertionError("G1: the rebuild frame's flow differs from "
                             "farneback with the new estimator_kwargs() "
                             f"(max |d| {(got - want).abs().max().item()})")
    before = statistics.mean(ms[1:G_BEFORE])  # the first frame primes
    after = statistics.mean(ms[G_BEFORE + 1:])
    print(f"G1 live tuning {HEIGHT}x{WIDTH} CvFlowConfig() -> "
          f"fb_iterations={G_ITERATIONS} through CvFlowConfigWindow."
          f"apply_value: 1 rebuild (frame {G_BEFORE}); B1/B2a/B2b/B8 a "
          "frame "
          f"{'/'.join(map(str, G_PER_FRAME[0]))} -> "
          f"{'/'.join(map(str, G_PER_FRAME[1]))}; 0 host syncs a frame "
          f"after the rebuild frame; the rebuild frame's flow bit-equal to "
          f"farneback(**estimator_kwargs()); ms/frame (host clock to a "
          f"synchronize, one frame at a time) before {before:.2f}, the "
          f"rebuild frame {ms[G_BEFORE]:.2f}, after {after:.2f}; on {card}")
    return {"before_ms": before, "rebuild_ms": ms[G_BEFORE],
            "after_ms": after}


def _g_fetch_part(port: int, deadline: float) -> bytes:
    """The first JPEG of the MJPEG stream on 127.0.0.1:``port``
    (``/transflow``), connecting again until the server is up."""
    import http.client
    while True:
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
            conn.request("GET", "/transflow")
            response = conn.getresponse()
            break
        except OSError:
            if time.time() > deadline:
                raise
            time.sleep(0.005)
    try:
        header = b""
        while not header.endswith(b"\r\n\r\n"):
            header += response.read(1)
        length = int(re.search(rb"Content-Length: (\d+)", header).group(1))
        return response.read(length)
    finally:
        conn.close()


def g_video(device, card: str, root: Path) -> str:
    """G2, where cv2 loads: ``G_FRAMES`` frames of phase F's pan at
    1080x1920 written by ``cv2.VideoWriter`` (MJPG in an .avi); the gray
    frames of ``CvFlowSource`` bit-equal to ``cv2.VideoCapture``'s own
    read; ``cli.main([clip, "-p", "noise", "--seed", "0", "-o",
    out/%04d.ppm])`` on the card (23 frames, 0 host syncs a frame against
    a 12-frame cut); then ``-o mjpeg:PORT`` with one multipart frame
    fetched over HTTP, which must decode to 1080x1920. Returns the clip's
    path."""
    import threading
    import cv2
    from transflow_tpu_torch.flow.sources.cv import CvFlowSource
    from transflow_tpu_torch.utils.imageio import read_netpbm
    clip = str(root / "clip.avi")
    rgb = panned_frames(G_FRAMES, HEIGHT, WIDTH, device,
                        step=FB_PAN).cpu().numpy()
    writer = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"MJPG"), G_FPS,
                             (WIDTH, HEIGHT))
    for frame in rgb:
        writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    writer.release()
    capture = cv2.VideoCapture(clip)
    want = []
    while True:
        ok, frame = capture.read()
        if not ok:
            break
        want.append(cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY))
    capture.release()
    with CvFlowSource(clip) as source:
        got = []
        for item in source:
            if item.prime is not None:
                got.append(np.asarray(item.prime))
            got.append(np.asarray(item.array))
    if len(got) != G_FRAMES or len(want) != G_FRAMES or not all(
            np.array_equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"G2: CvFlowSource's {len(got)} gray frames "
                             f"differ from cv2.VideoCapture's {len(want)}")
    flows_n = G_FRAMES - 1

    def argv(out: str, *extra: str) -> list[str]:
        (root / out).mkdir(exist_ok=True)
        return [clip, "-p", "noise", "--seed", str(SEED), "-o",
                str(root / out / "%04d.ppm"), *extra]

    run = _p_run(argv("out"), count_syncs=True)
    cut = _p_run(argv("cut", "-t", G_CUT), count_syncs=True)
    if run["pipeline"].engine.device != device:
        raise AssertionError(f"G2: the Engine ran on "
                             f"{run['pipeline'].engine.device}")
    syncs = (run["syncs"] - cut["syncs"]) / (flows_n - G_CUT_FRAMES)
    written = sorted((root / "out").glob("*.ppm"))
    if len(written) != flows_n or read_netpbm(str(written[-1])).shape != (
            HEIGHT, WIDTH, 3):
        raise AssertionError(f"G2: {len(written)} frames written, expected "
                             f"{flows_n} at {HEIGHT}x{WIDTH}")
    per_frame = tuple(n / flows_n for n in fb_launches(run["launches"]))
    if per_frame != FB_DEFAULT_PER_FRAME:
        raise AssertionError(f"G2: {FB_NAMES} launches a frame "
                             f"{per_frame}, expected {FB_DEFAULT_PER_FRAME}")
    print(f"G2 video CLI {HEIGHT}x{WIDTH} clip.avi (MJPG, cv2) -p noise -o "
          f"out/%04d.ppm {flows_n} frames: {_p_split(run, flows_n)}; "
          f"launches B1/B2a/B2b/B8 a frame {per_frame}; host syncs "
          f"{run['syncs']} against {cut['syncs']} for the {G_CUT_FRAMES}-"
          f"frame cut: {syncs:g} a frame; on {card}")
    if syncs != 0:
        raise AssertionError(f"G2: {syncs} host syncs a frame")
    port = _free_port()
    fetched: dict = {}

    def fetch():
        try:
            fetched["jpeg"] = _g_fetch_part(port, time.time() + G_TIMEOUT)
        except Exception as err:  # noqa: BLE001 — reported below
            fetched["error"] = err

    client = threading.Thread(target=fetch, daemon=True)
    client.start()
    stream = _p_run([clip, "-p", "noise", "--seed", str(SEED), "-o",
                     f"mjpeg:{port}:127.0.0.1"])
    client.join(G_TIMEOUT)
    if "jpeg" not in fetched:
        raise AssertionError(f"G2: no MJPEG frame fetched: "
                             f"{fetched.get('error', 'timed out')}")
    image = cv2.imdecode(np.frombuffer(fetched["jpeg"], np.uint8),
                         cv2.IMREAD_COLOR)
    if image is None or image.shape != (HEIGHT, WIDTH, 3):
        raise AssertionError(f"G2: the MJPEG frame decodes to "
                             f"{None if image is None else image.shape}")
    print(f"G2 video CLI -o mjpeg:{port}: a multipart frame of "
          f"{len(fetched['jpeg'])} bytes fetched over HTTP decodes to "
          f"{HEIGHT}x{WIDTH}; {_p_split(stream, flows_n)}; on {card}")
    g_headline(root, clip, rgb[0], card)
    return clip


def g_headline(root: Path, clip: str, still: np.ndarray, card: str) -> None:
    """The headline command, ``clip.avi -p still.png -o out.mp4``, on the
    card: the encoder chain's first writer that opens writes ``out.mp4``,
    which must reopen through ``cv2.VideoCapture`` at 1080x1920 with 23
    frames."""
    import cv2
    from transflow_tpu_torch.utils.imageio import imwrite
    imwrite(str(root / "still.png"), still)
    out = str(root / "out.mp4")
    run = _p_run([clip, "-p", str(root / "still.png"), "-o", out])
    output = run["pipeline"].output_threads[0].output
    capture = cv2.VideoCapture(out)
    count = 0
    while True:
        ok, frame = capture.read()
        if not ok:
            break
        count += 1
        shape = frame.shape
    capture.release()
    flows_n = G_FRAMES - 1
    if count != flows_n or shape != (HEIGHT, WIDTH, 3):
        raise AssertionError(f"G2: out.mp4 reopens with {count} frames "
                             f"of {shape}, expected {flows_n} at "
                             f"{HEIGHT}x{WIDTH}")
    print(f"G2 headline CLI clip.avi -p still.png -o out.mp4: written by "
          f"{output.opened_by}, reopens through cv2.VideoCapture as "
          f"{count} frames at {HEIGHT}x{WIDTH}; {_p_split(run, flows_n)}; "
          f"on {card}")


def g_gui(device, card: str, root: Path, clip: str) -> None:
    """G3, where aiohttp and websockets load too: ``GuiServer`` on free
    ports rendering on the card, one ``GENERATE`` of G2's command over a
    ``G_GUI_FRAMES``-frame cut: ``STATUS`` messages, then ``DONE`` with
    the output's path and its frames written."""
    import websockets.sync.client
    from transflow_tpu_torch.gui.server import GuiServer
    server = GuiServer("127.0.0.1", _free_port(), _free_port(),
                       device=device)
    server.start(block=False, open_browser=False)
    out = root / "gui"
    out.mkdir()
    config = {"flow_path": clip, "output_path": str(out / "%04d.ppm"),
              "pixmap_sources": [{"path": "noise", "layers": [0]}],
              "seed": SEED, "duration_time": G_GUI_CUT}
    statuses, done = 0, None
    start = time.perf_counter()
    try:
        with websockets.sync.client.connect(
                f"ws://127.0.0.1:{server.ws_port}",
                open_timeout=G_TIMEOUT) as ws:
            ws.send("GENERATE " + json.dumps(config))
            deadline = time.time() + G_TIMEOUT
            while done is None and time.time() < deadline:
                message = ws.recv(timeout=G_TIMEOUT)
                if message.startswith("STATUS"):
                    status = json.loads(message[len("STATUS"):])
                    if status.get("error"):
                        raise AssertionError(f"G3: {message}")
                    statuses += 1
                elif message.startswith("DONE"):
                    done = message
                elif message.startswith("ERROR"):
                    raise AssertionError(f"G3: {message}")
    finally:
        server.stop()
    seconds = time.perf_counter() - start
    written = sorted(out.glob("*.ppm"))
    if done is None or str(out / "%04d.ppm") not in done or not statuses \
            or len(written) != G_GUI_FRAMES:
        raise AssertionError(f"G3: {statuses} STATUS, {done!r}, "
                             f"{len(written)} frames written; expected "
                             f"STATUS, then DONE with the output's path, "
                             f"{G_GUI_FRAMES} frames")
    if server.pipeline.engine.device != device:
        raise AssertionError(f"G3: the job ran on "
                             f"{server.pipeline.engine.device}")
    print(f"G3 GUI GENERATE over the websocket: {statuses} STATUS, then "
          f"{done!r}; {len(written)} frames at {HEIGHT}x{WIDTH} in "
          f"{seconds:.2f} s from GENERATE to DONE; on {card}")


def _g_absent(route: str, modules: tuple) -> bool:
    """Print ``route``'s absent line where one of ``modules`` does not
    import; True where all import."""
    import importlib
    versions = []
    for module in modules:
        try:
            loaded = importlib.import_module(module)
            versions.append(f"{module} {getattr(loaded, '__version__', '?')}")
        except ImportError as err:
            print(f"{route}: absent: {err}")
            return False
    print(f"{route}: loaded {', '.join(versions)}")
    return True


def phase_live(device, card: str) -> dict:
    """Phase G: live tuning on the card (G1); where cv2 loads, the video
    input and the MJPEG preview (G2); where aiohttp and websockets load
    too, the web GUI (G3). A route whose library is missing prints its
    absent line; one whose libraries load and then fails fails the run."""
    import tempfile
    result = {"g1": g_live_tuning(device, card)}
    if not _g_absent("G2", ("cv2", "aiohttp")):
        print("G3: absent: G2's libraries")
        return result
    with tempfile.TemporaryDirectory(prefix="chip_smoke_g_") as tmp:
        clip = g_video(device, card, Path(tmp))
        if _g_absent("G3", ("websockets",)):
            g_gui(device, card, Path(tmp), clip)
    return result


K_CHUNKS_PER_SAMPLE = 4  # the bench's chained chunks a sample (32 in full)
K_REPEATS = 3            # its steady-state samples (15 in full)
K_E2E_FRAMES = 24        # its --e2e clip's frames (96 in full)
K_FUZZ_CASES = 3
K_FUZZ_SEED = 5          # the CPU tests' cases: a video source with a
#                          checkpoint cadence, the archive with one, a lock
K_FUZZ_SIZE = (96, 128)
# A1, A3, B7, B16, B17, B18 launches a LiteFlowNet frame at bound 0
K_LFN_PER_FRAME = {"A1": 5, "A3": 0, "B7": B7_EXACT} | LFN_HEADS
K_FIELDS = ("metric", "value", "unit", "vs_baseline", "ms_per_frame",
            "best_fps", "noise_iqr_pct", "samples", "window_fps",
            "stage_ms", "hbm_io_gbps",
            "carry_state_mb", "cpu_reference_fps",
            "liteflownet_1088p_ms_per_frame", "liteflownet_1088p_fps",
            "fastest_preset", "e2e_fps_still_pixmap",
            "e2e_fps_video_pixmap", "e2e_fps_archive_replay",
            "launches_per_frame", "host_syncs_per_frame", "card")


def phase_bench(device, card: str) -> dict:
    """Phase K: the port's bench (``transflow_tpu_torch/bench.py``) in
    this process with ``--e2e``, cut to K_CHUNKS_PER_SAMPLE chunks a
    sample, K_REPEATS samples and K_E2E_FRAMES frames: its record (printed
    on its own line) has every field, B1/B2a/B2b/B8 4/12/12/1 and
    A1/A3/B7/B16/B17/B18 5/0/14/6/5/93 launches a frame, 0 host syncs a
    frame and this card; then
    K_FUZZ_CASES cases of the chunk fuzzer on the card at K_FUZZ_SIZE,
    each bit-equal chunked, per frame and resumed."""
    from transflow_tpu_torch import bench
    from transflow_tpu_torch.tools import fuzz_chunks
    cuts = {"CHUNKS_PER_SAMPLE": K_CHUNKS_PER_SAMPLE, "REPEATS": K_REPEATS,
            "E2E_FRAMES": K_E2E_FRAMES}
    saved = {name: getattr(bench, name) for name in cuts}
    for name, value in cuts.items():
        setattr(bench, name, value)
    start = time.perf_counter()
    try:
        record = bench.main(["--e2e"], device=device)
    finally:
        for name, value in saved.items():
            setattr(bench, name, value)
    seconds = time.perf_counter() - start
    missing = [name for name in K_FIELDS if name not in record]
    if missing:
        raise AssertionError(f"K: the bench's record lacks {missing}")
    if record["metric"] != "1080p_e2e_fps_flow_warp_composite" or not (
            record["value"] > 0 and record["vs_baseline"] > 0):
        raise AssertionError(f"K: bad headline {record['metric']} "
                             f"{record['value']} {record['vs_baseline']}")
    fb = record["launches_per_frame"]["flagship"]
    lfn = record["launches_per_frame"]["liteflownet"]
    if tuple(fb[n] for n in FB_NAMES) != FB_DEFAULT_PER_FRAME or \
            (fb["K0"], fb["K1"], fb["K2"]) != C_MOVEREF or \
            lfn != K_LFN_PER_FRAME:
        raise AssertionError(f"K: launches a frame {fb}, {lfn}; expected "
                             f"{FB_DEFAULT_PER_FRAME}, K0/K1/K2 {C_MOVEREF} "
                             f"and {K_LFN_PER_FRAME}")
    if record["host_syncs_per_frame"] != 0:
        raise AssertionError(f"K: {record['host_syncs_per_frame']} host "
                             "syncs a frame")
    if f"{record['card']['name']}, {record['card']['power_limit']}" != card:
        raise AssertionError(f"K: the record's card {record['card']} is "
                             f"not {card}")
    print(f"K bench {bench.HEIGHT}x{bench.WIDTH} (chunks of {bench.CHUNK}, "
          f"{K_CHUNKS_PER_SAMPLE} a sample, {K_REPEATS} samples after "
          f"{record['warmup_samples']} warm-up): {record['value']:.2f} "
          f"frames/s, {record['ms_per_frame']:.3f} ms/frame (median; "
          f"{record['window_fps']:.2f} frames/s over the {record['samples']} "
          f"samples' window), "
          f"vs_baseline {record['vs_baseline']:.2f}; liteflownet "
          f"{record['liteflownet_1088p_ms_per_frame']:.2f} ms/frame; "
          f"fastest {record['fastest_preset']['ms_per_frame']:.3f} "
          f"ms/frame; e2e over {K_E2E_FRAMES} frames still / video / "
          f"replay {record['e2e_fps_still_pixmap']:.2f} / "
          f"{record['e2e_fps_video_pixmap']:.2f} / "
          f"{record['e2e_fps_archive_replay']:.2f} frames/s; the phase "
          f"{seconds:.1f} s on {card}")
    size = (fuzz_chunks.H, fuzz_chunks.W)
    fuzz_chunks.H, fuzz_chunks.W = K_FUZZ_SIZE
    try:
        failures = fuzz_chunks.run(K_FUZZ_CASES, K_FUZZ_SEED, device=device)
    finally:
        fuzz_chunks.H, fuzz_chunks.W = size
    if failures:
        raise AssertionError(f"K: {failures} of {K_FUZZ_CASES} fuzzer cases "
                             "differ")
    return record


def hs_bound_ms(kernel: str, h: int, w: int) -> tuple[float, str]:
    """B9's bound: two frames' bytes in, four float32 planes out; B10's a
    launch: the four planes and the flow in, the flow out; a copy-through
    launch of B10 (the stop word set): the flow in and out."""
    px = h * w
    if kernel == "hs_derivatives":
        return _bound(px * (2 + 16), B9_OPS * px)
    if kernel == "hs_iterate_copy":
        return _bound(px * (8 + 8), 0)
    return _bound(px * (16 + 8 + 8), B10_OPS * px)


def lk_bound_ms(kernel: str, h: int, w: int) -> tuple[float, str]:
    """B11's bound a launch: prev, ix, iy, the flow and the sampled image in
    (each pixel once), two planes out; B12's: two planes, four tensor
    planes and the flow in, the flow out (the tensor mode: ix, iy in,
    four planes out)."""
    px = h * w
    if kernel == "lk_warp_products":
        return _bound(px * (4 * 4 + 8 + 8), B11_OPS * px)
    if kernel == "lk_structure_tensor":
        return _bound(px * (8 + 16), B12_OPS["tensor"] * px)
    return _bound(px * (8 + 16 + 8 + 8), B12_OPS["solve"] * px)


def phase_classic_kernels(device) -> list[dict]:
    """B9 and B10 at 1080x1920 on the pan's frames, and B11, B12 (both
    modes) at the three levels of Lucas-Kanade's 1080p pyramid on the
    pan's images, their Scharr derivatives and the pan's flow at the
    level, each against its plain version on the same inputs on the card:
    bit-equal; ``device_ms``, the bound and its share, ``call_ms`` and the
    plain version's time. B10 runs with ``delta=0.0`` in the timing loops,
    so every launch steps and runs the reduction every preset runs; one
    copy-through launch (the stop word set) is timed beside it: the floor
    of its blocks' fixed costs. B14 makes the pyramid of the pan's uint8
    pair in one launch, beside the path it replaced (``b14_replaced``) on
    the same frames, then each level below L0 from one image of the level
    above."""
    from transflow_tpu_torch.flow.estimators import lucas_kanade as lke
    from transflow_tpu_torch.ops import horn_schunck as hs
    from transflow_tpu_torch.ops import lucas_kanade as lk
    from transflow_tpu_torch.ops import pyramid
    rows = []

    def record(kernel, level, h, w, err, call, plain, bound, variant=""):
        row = {"kernel": kernel, "level": level, "err": err,
               "variant": variant}
        row["bound_ms"], row["bound_by"] = bound
        row["device_ms"] = device_ms(call)
        row["call_ms"] = call_ms(call)
        row["plain_ms"] = device_ms(plain, PLAIN_LAUNCHES, warmup=1)
        row["call"] = call  # profiled in phase 10
        print(f"classic {kernel} {level} ({h},{w}) {variant}: bit-equal to "
              f"plain; device_ms {row['device_ms']:.5f} bound "
              f"{row['bound_ms']:.5f} ({row['bound_by']}) share "
              f"{row['bound_ms'] / row['device_ms']:.1%}; call "
              f"{row['call_ms']:.4f} ms (host-inclusive); plain "
              f"{row['plain_ms']:.4f} ms")
        rows.append(row)
        return row

    gray = gray_frames(2, HEIGHT, WIDTH, device)
    a, b = gray[1].contiguous(), gray[0].contiguous()
    planes, control = hs.hs_derivatives_cuda(a, b, 1.0)
    want, _ = hs.hs_derivatives_plain(a, b, 1.0)
    _fb_compare("B9", planes, want)
    record("hs_derivatives", "L0", HEIGHT, WIDTH, 0.0,
           functools.partial(hs.hs_derivatives_cuda, a, b, 1.0),
           functools.partial(hs.hs_derivatives_plain, a, b, 1.0),
           hs_bound_ms("hs_derivatives", HEIGHT, WIDTH))
    flow = torch.zeros((HEIGHT, WIDTH, 2), device=device)
    plain_control = control.clone()
    got, ref = flow, flow
    for step in range(3):   # horn-schunck.json's iterations, delta 1
        got = hs.hs_iterate_cuda(planes, got, control, 1.0)
        ref = hs.hs_iterate_plain(want, ref, plain_control, 1.0)
        _fb_compare(f"B10 step {step}", got, ref)
    if not torch.equal(control[:2], plain_control[:2]):
        raise AssertionError(f"B10's control {control.tolist()} against "
                             f"the plain version's {plain_control.tolist()}")
    print(f"classic hs_iterate {HEIGHT}x{WIDTH} on the pan: "
          f"{int(control[1])} of 3 "
          f"iterations taken (stop word {int(control[0])}), bit-equal; "
          f"{hs.iterate_partials(HEIGHT, WIDTH)} partial sums a launch "
          "(transflow_hs_iterate_partials)")
    fresh = torch.zeros_like(control)
    record("hs_iterate", "L0", HEIGHT, WIDTH, 0.0,
           functools.partial(hs.hs_iterate_cuda, planes, got, fresh, 0.0),
           functools.partial(hs.hs_iterate_plain, want, got, fresh.cpu(),
                             0.0),
           hs_bound_ms("hs_iterate", HEIGHT, WIDTH), "delta 0")
    if int(fresh[0]):
        raise AssertionError("B10 stopped under delta 0")
    stopped = torch.tensor([1, 0, 0, 0], dtype=torch.int32, device=device)
    _fb_compare("B10 copy-through", hs.hs_iterate_cuda(planes, got, stopped,
                                                       1.0), got)
    record("hs_iterate_copy", "L0", HEIGHT, WIDTH, 0.0,
           functools.partial(hs.hs_iterate_cuda, planes, got, stopped, 1.0),
           functools.partial(hs.hs_iterate_plain, want, got, stopped.cpu(),
                             1.0),
           hs_bound_ms("hs_iterate_copy", HEIGHT, WIDTH), "stop word set")
    # B14: lukas-kanade.json's pyramid of the pan's uint8 pair in one
    # launch (the main row), beside the path it replaced; then each level
    # alone through the one-reduce path (``ops/image.py::downsample2x``)
    args = (a, b, H_LK_WIN, H_LK_MAX_LEVEL)
    levels = pyramid.lk_pyramid_cuda(*args)
    want = pyramid.lk_pyramid_plain(*args)
    for (lh, lw, level), got, ref in zip(H_LK_LEVELS, levels, want):
        for k in range(2):
            if got[k].shape != (lh, lw):
                raise AssertionError(f"B14 {level} image {k}: shape "
                                     f"{tuple(got[k].shape)}")
            _fb_compare(f"B14 {level} image {k}", got[k], ref[k])
    row = record("lk_pyramid", "L0-L2", HEIGHT, WIDTH, 0.0,
                 functools.partial(pyramid.lk_pyramid_cuda, *args),
                 functools.partial(pyramid.lk_pyramid_plain, *args),
                 pyramid_bound_ms("lk_pyramid", HEIGHT, WIDTH,
                                  [(lh, lw, 0.0)
                                   for lh, lw, _ in H_LK_LEVELS[1:]], U8),
                 "both uint8 frames, one launch")
    replaced = functools.partial(b14_replaced, a, b, len(H_LK_LEVELS))
    row["replaced_ms"] = device_ms(replaced, PLAIN_LAUNCHES * 10)
    row["replaced_call"] = replaced  # profiled in phase 10
    print(f"classic lk_pyramid: the path it replaced (the frames' casts "
          f"and a reduce a level) {row['replaced_ms']:.5f} ms")
    for (h, w, level), (x, _) in zip(H_LK_LEVELS[1:], levels):
        ph, pw = x.shape
        got = pyramid.downsample2x_cuda((x,))[0]
        _fb_compare(f"B14 {level} alone", got,
                    pyramid.downsample2x_plain((x,))[0])
        record("downsample2x", level, h, w, 0.0,
               functools.partial(pyramid.downsample2x_cuda, (x,)),
               functools.partial(pyramid.downsample2x_plain, (x,)),
               pyramid_bound_ms("downsample2x", ph, pw, ((h, w, 0.0),), F32,
                                images=1), f"from ({ph},{pw}), one image")
    for (h, w, level), (prev, nxt) in zip(H_LK_LEVELS, levels):
        ix, iy = lke._scharr(prev, 1), lke._scharr(prev, 0)
        flow = pan_flow(h, w, device)
        args = (prev, nxt, ix, iy, flow)
        got = lk.lk_warp_products_cuda(*args)
        _fb_compare(f"B11 {level}", got,
                    lk.lk_warp_products_plain(*args))
        record("lk_warp_products", level, h, w, 0.0,
               functools.partial(lk.lk_warp_products_cuda, *args),
               functools.partial(lk.lk_warp_products_plain, *args),
               lk_bound_ms("lk_warp_products", h, w), "pan flow")
        tensor = lk.lk_structure_tensor_cuda(ix, iy, 15)
        _fb_compare(f"B12 tensor {level}", tensor,
                    lk.lk_structure_tensor_plain(ix, iy, 15))
        record("lk_structure_tensor", level, h, w, 0.0,
               functools.partial(lk.lk_structure_tensor_cuda, ix, iy, 15),
               functools.partial(lk.lk_structure_tensor_plain, ix, iy, 15),
               lk_bound_ms("lk_structure_tensor", h, w), "window 15")
        solve = (got, tensor, flow, 15, lke.EPS)
        _fb_compare(f"B12 solve {level}", lk.lk_window_solve_cuda(*solve),
                    lk.lk_window_solve_plain(*solve))
        record("lk_window_solve", level, h, w, 0.0,
               functools.partial(lk.lk_window_solve_cuda, *solve),
               functools.partial(lk.lk_window_solve_plain, *solve),
               lk_bound_ms("lk_window_solve", h, w), "window 15")
    return rows


def b5_inputs(device, pan_flow) -> dict:
    """B5's 1080p inputs: a random forward flow, a converging one (every
    pixel onto the centre: one word takes every write), Farneback's
    forward flow on the pan, and a constant (W/2, 0), the pan that ``-f``
    scales past the frame's edge: the right half of each row clips onto
    the row's last pixel (960 writers on each of 1,080 words)."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    ii = torch.arange(HEIGHT, device=device, dtype=torch.float32)[:, None]
    jj = torch.arange(WIDTH, device=device, dtype=torch.float32)[None, :]
    converge = torch.stack([(WIDTH // 2 - jj).expand(HEIGHT, WIDTH),
                            (HEIGHT // 2 - ii).expand(HEIGHT, WIDTH)], -1)
    edge = torch.zeros((HEIGHT, WIDTH, 2), device=device)
    edge[..., 0] = WIDTH / 2
    return {"random": torch.randn((HEIGHT, WIDTH, 2), generator=gen,
                                  device=device) * 8,
            "converge": converge.contiguous(), "farneback pan": pan_flow,
            "edge": edge}


def b5_bound_ms(h: int, w: int) -> tuple[float, str]:
    """B5's bound: the 8-byte flow read and the 8-byte output written
    once per pixel; its integer work is a few operations per pixel."""
    return _bound(16 * h * w, 0)


def phase_scatter_kernel(device, pan_flow) -> list[dict]:
    """Kernel B5 against its plain version at 1080x1920 on each of
    ``b5_inputs``: bit-equal, ``device_ms``, kernel time (every device
    event of a call: its two kernels), bound and share."""
    from transflow_tpu_torch.ops.scatter import (forward_to_backward_cuda,
                                                 forward_to_backward_plain)
    rows = []
    for name, flow in b5_inputs(device, pan_flow).items():
        got = forward_to_backward_cuda(flow)
        want = forward_to_backward_plain(flow)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        moved = int((want != 0).any(dim=-1).sum().item())
        if not torch.equal(got, want):
            raise AssertionError(f"B5 {name}: max |err| {err}")
        bound, by = b5_bound_ms(HEIGHT, WIDTH)
        row = {"flow": name, "err": err, "bound_ms": bound, "bound_by": by,
               "device_ms": device_ms(lambda: forward_to_backward_cuda(flow)),
               "call_ms": call_ms(lambda: forward_to_backward_cuda(flow)),
               "plain_ms": device_ms(lambda: forward_to_backward_plain(flow),
                                     PLAIN_LAUNCHES, warmup=1),
               "call": lambda f=flow: forward_to_backward_cuda(f)}
        print(f"B5 {HEIGHT}x{WIDTH} {name}: bit-equal to plain ({moved} "
              f"targets written); device_ms {row['device_ms']:.5f}, bound "
              f"{bound:.5f} ({by}), share {bound / row['device_ms']:.1%}, "
              f"call {row['call_ms']:.4f} (host-inclusive), plain "
              f"{row['plain_ms']:.4f}")
        rows.append(row)
    return rows


def phase_engine(device, card: str) -> dict:
    """The Engine at lfn_warp_bound=16 and =0 on the same frames, each
    with 0 host syncs a frame; returns the runs, the frames and the
    pixmap."""
    os.environ["TRANSFLOW_LITEFLOWNET_RANDOM"] = "1"
    # and the frames of the bound-0 Engine's profile (phase 10)
    n = (1 + ENGINE_WARMUP + ENGINE_FRAMES + ENGINE_CALLS + LFN_SYNC_CALLS
         + 2 + LFN_PROFILE_CALLS)
    frames = panned_frames(n, HEIGHT, WIDTH, device)
    pixmap = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 256, (HEIGHT, WIDTH, 3), dtype=np.uint8)).to(device)
    runs = {bound: run_engine(device, frames, pixmap, lfn_config(bound))
            for bound in (WARP_BOUND, 0)}
    for bound, run in runs.items():
        a3, a1, a2 = run["chunk_launches"][:3]
        print(f"engine {HEIGHT}x{WIDTH} liteflownet lfn_warp_bound={bound} "
              f"->moveref: {run['ms']:.2f} ms/frame "
              f"{1e3 / run['ms']:.2f} frames/s over a chunk of "
              f"{ENGINE_FRAMES} (max |flow| {run['max_flow']:.4g}, "
              f"checksum {run['checksum']}) on {card}")
        print(f"engine lfn_warp_bound={bound} launches over the chunk: "
              f"bounded_backwarp {a3}, correlation7x7 {a1}, "
              f"sharded_correlation7x7 {a2}; with {ENGINE_CALLS} "
              f"process_frame calls: {run['launches']}")
        _check_engine_run(f"lfn_warp_bound={bound}", run,
                          lfn_row(A3=9 if bound else 0, A1=5,
                                  B7=B7_BOUNDED if bound else B7_EXACT))
        run["syncs"] = host_syncs(run, LFN_SYNC_CALLS)
        print(f"engine lfn_warp_bound={bound}: launches per frame "
              f"{_per_frame_text(run)}; {run['syncs']:g} host syncs per "
              f"frame (torch.cuda.set_sync_debug_mode, {LFN_SYNC_CALLS} "
              "process_frame call)")
        if run["syncs"]:
            raise AssertionError(f"lfn_warp_bound={bound}: {run['syncs']} "
                                 "host syncs per frame")
    diff = (runs[WARP_BOUND]["flows"] - runs[0]["flows"]).abs().max().item()
    print(f"engine max |flow(lfn_warp_bound={WARP_BOUND}) - "
          f"flow(lfn_warp_bound=0)| {diff:.3e} over the chunk")
    return {"runs": runs, "frames": frames, "pixmap": pixmap}


def phase_mesh_engine(device, card: str, engine_phase: dict) -> dict:
    """The lfn_warp_bound=16 Engine under a 4-shard mesh of the card with
    halo=8, on phase 4's frames, against its meshless bound-0 run."""
    from transflow_tpu_torch.parallel import make_space_mesh
    mesh = make_space_mesh(MESH_SHARDS, devices=[device] * MESH_SHARDS)
    run = run_engine(device, engine_phase["frames"], engine_phase["pixmap"],
                     lfn_config(WARP_BOUND), mesh=mesh, halo=MESH_HALO)
    ref = engine_phase["runs"][0]
    a3, a1, a2 = run["chunk_launches"][:3]
    print(f"mesh engine {HEIGHT}x{WIDTH} {mesh} halo={MESH_HALO} "
          f"liteflownet (lfn_warp_bound={WARP_BOUND} stripped) ->moveref: "
          f"{run['ms']:.2f} ms/frame against {ref['ms']:.2f} meshless "
          f"(lfn_warp_bound=0) over a chunk of {ENGINE_FRAMES} (max |flow| "
          f"{run['max_flow']:.4g}, checksum {run['checksum']}) on {card}")
    print(f"mesh engine launches over the chunk: bounded_backwarp {a3}, "
          f"correlation7x7 {a1}, sharded_correlation7x7 {a2}; with "
          f"{ENGINE_CALLS} process_frame calls: {run['launches']}")
    _check_engine_run("mesh engine", run,
                      lfn_row(C_MESH, A1=1, A2=A2_PER_FRAME, B7=B7_EXACT))
    diff = max((run["flows"] - ref["flows"]).abs().max().item(),
               (run["call_flows"] - ref["call_flows"]).abs().max().item())
    same = (torch.equal(run["out"], ref["out"])
            and torch.equal(run["call_frames"], ref["call_frames"]))
    print(f"mesh engine vs meshless: max |dflow| {diff:.3e}, frames "
          f"{'bit-equal' if same else 'DIFFER'} over "
          f"{ENGINE_FRAMES + ENGINE_CALLS} frames")
    if not diff <= MESH_FLOW_ATOL:
        raise AssertionError(f"mesh engine flows differ by {diff}")
    if not same:
        raise AssertionError("mesh engine frames differ from meshless")
    run["turns"] = engines_in_turns(device, card, engine_phase, mesh)
    return run


def engines_in_turns(device, card: str, engine_phase: dict, mesh) -> dict:
    """The meshless bound-0 Engine (A) and the mesh Engine (B) on one
    panned clip, ``process_frame`` windows of ``TURN_WINDOW`` frames in
    ``TURN_ROUNDS`` rounds of ABBA after a warm-up frame each: host clock
    around each window, which ends in a synchronize. Returns each
    Engine's median ms/frame."""
    pixmap = engine_phase["pixmap"]
    frames = panned_frames(2 + 2 * TURN_ROUNDS * TURN_WINDOW, HEIGHT, WIDTH,
                           device)
    engines = {"meshless": make_engine(device, frames, lfn_config(0)),
               "mesh": make_engine(device, frames, lfn_config(WARP_BOUND),
                                   mesh, MESH_HALO)}
    streams, fnos, times = {}, {}, {name: [] for name in engines}
    for name, (engine, source) in engines.items():
        streams[name] = iter(source)
        engine.process_frame([next(streams[name])], ((pixmap,),), 0.0,
                             ((0,),))
        fnos[name] = 1
    torch.cuda.synchronize()
    for name in ("meshless", "mesh", "mesh", "meshless") * TURN_ROUNDS:
        engine = engines[name][0]
        start = time.perf_counter()
        for _ in range(TURN_WINDOW):
            fno = fnos[name]
            engine.process_frame([next(streams[name])], ((pixmap,),),
                                 fno / 30.0, ((fno,),))
            fnos[name] += 1
        torch.cuda.synchronize()
        times[name].append(1e3 * (time.perf_counter() - start) / TURN_WINDOW)
    result = {name: statistics.median(t) for name, t in times.items()}
    print(f"engines in turns ({TURN_ROUNDS} x ABBA, {TURN_WINDOW}-frame "
          "windows): "
          f"meshless {result['meshless']:.2f} ms/frame, mesh x{MESH_SHARDS} "
          f"{result['mesh']:.2f} ms/frame (medians; windows "
          f"{[round(t, 2) for t in times['meshless']]} and "
          f"{[round(t, 2) for t in times['mesh']]}) on {card}")
    return result


def a2_plain(f1, f2, mesh, stride: int):
    """The plain version of A2: the library's shard segments,
    ``correlation7x7_segments`` on each shard, joined."""
    from transflow_tpu_torch.ops.correlation import (_stage_dtype,
                                                     correlation7x7_segments,
                                                     shard_segments)
    shards = shard_segments(_stage_dtype(f1), _stage_dtype(f2), mesh, stride)
    return torch.cat([correlation7x7_segments(*s[:4], stride).to(f1.device)
                      for s in shards])


def a2_views(f1, f2, mesh, stride: int):
    """A2's launch on a one-card mesh from the descriptors that serve
    shards across cards (``shard_segments``' views through
    ``shard_table``) in place of ``one_card_table``'s addresses: the same
    kernel and output, with the host work that the one-card descriptors
    spare. Counts nothing."""
    from transflow_tpu_torch.ops.correlation import (WINDOW, _launch_shards,
                                                     _stage_dtype,
                                                     shard_segments)
    f1, f2 = _stage_dtype(f1), _stage_dtype(f2)
    h, w = f1.shape[:2]
    out = torch.empty((-(-h // stride), -(-w // stride), WINDOW * WINDOW),
                      device=f1.device)
    shards = shard_segments(f1, f2, mesh, stride)
    _launch_shards(shards, out, [s.out_row0 for s in shards], stride)
    return out


def phase_sharded_kernels(device) -> list[dict]:
    """Kernel A2 against A1 (bit-equal) and its plain version (1e-5) at
    the five correlation shapes in the slice's dtype pairs; one launch per
    call on one card. Beside it, the same launch from the views'
    descriptors (``a2_views``), bit-equal to A1 too, for what the one-card
    descriptors save the host."""
    from transflow_tpu_torch.ops.correlation import (correlation7x7_cuda,
                                                     sharded_correlation7x7,
                                                     sharded_ok)
    from transflow_tpu_torch.parallel import make_space_mesh
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    rows = []
    for h, w, c, stride, level in CORR_SHAPES:
        t1, t2 = MAIN_PAIR[level]
        f1 = torch.randn((h, w, c), generator=gen, device=device).to(t1)
        f2 = torch.randn((h, w, c), generator=gen, device=device).to(t2)
        a1 = correlation7x7_cuda(f1, f2, stride)
        for n in (MESH_SHARDS, 2):
            if not sharded_ok(h, n, stride):
                print(f"a2 {level} ({h},{w},{c}) s{stride} x{n}: H does not "
                      "shard (sharded_ok false), unsharded A1 runs there")
                continue
            mesh = make_space_mesh(n, devices=[device] * n)
            before = sharded_correlation7x7.launches
            got = sharded_correlation7x7(f1, f2, mesh, stride)
            launches = sharded_correlation7x7.launches - before
            plain = a2_plain(f1, f2, mesh, stride)
            views = a2_views(f1, f2, mesh, stride)
            torch.cuda.synchronize()
            err_a1 = max((got - a1).abs().max().item(),
                         (views - a1).abs().max().item())
            err = (got - plain).abs().max().item()
            ok = torch.allclose(got, plain, atol=CORR_ATOL, rtol=CORR_RTOL)
            if err_a1 > A2_ATOL or not ok or launches != 1:
                raise AssertionError(
                    f"A2 disagrees at {level} x{n}: |A2-A1| {err_a1} (both "
                    f"descriptors), |A2-plain| {err}, {launches} launches "
                    "(expected 1)")
            row = {"level": level, "shards": n, "err": err,
                   "err_a1": err_a1}
            row["bound_ms"], row["bound_by"] = corr_bound_ms(h, w, c, stride,
                                                             t1, t2)
            call = functools.partial(sharded_correlation7x7, f1, f2, mesh,
                                     stride)
            row["call"] = call  # profiled in phase 10
            row["device_ms"] = device_ms(call)
            row["views_device_ms"] = device_ms(
                lambda: a2_views(f1, f2, mesh, stride))
            row["a1_device_ms"] = device_ms(
                lambda: correlation7x7_cuda(f1, f2, stride))
            row["call_ms"] = call_ms(call)
            row["plain_ms"] = device_ms(
                lambda: a2_plain(f1, f2, mesh, stride), PLAIN_LAUNCHES)
            print(f"a2 {level} ({h},{w},{c}) s{stride} x{n} {_pair(t1, t2)}: "
                  f"|A2-A1| {err_a1:.3e} |A2-plain| {err:.3e}; device_ms A2 "
                  f"{row['device_ms']:.5f} (from views "
                  f"{row['views_device_ms']:.5f}) A1 "
                  f"{row['a1_device_ms']:.5f} bound {row['bound_ms']:.5f}; "
                  f"call {row['call_ms']:.4f} ms (host-inclusive); plain "
                  f"{row['plain_ms']:.4f} ms")
            rows.append(row)
    count = torch.cuda.device_count()
    if count >= 2:
        h, w, c, stride, level = CORR_SHAPES[-1]
        n = min(MESH_SHARDS, count)
        f1 = torch.randn((h, w, c), generator=gen, device=device).to(BF16)
        f2 = torch.randn((h, w, c), generator=gen, device=device)
        got = sharded_correlation7x7(f1, f2, make_space_mesh(n), stride)
        err = (got - correlation7x7_cuda(f1, f2, stride)).abs().max().item()
        print(f"a2 {level} over {n} cards: |A2-A1| {err:.3e}")
        if err > A2_ATOL:
            raise AssertionError(f"A2 over {n} cards disagrees: {err}")
    return rows


def fb_bound_ms(kernel: str, h: int, w: int, storage, in_dtype=None,
                variant=0) -> tuple[float, str]:
    """A Farneback kernel's bound at (h, w): each input and output byte
    once (B1: both images in, five planes of each out; B2a: the flow, both
    images' planes, six planes out; B2b: six planes and the flow in, the
    flow out) and its float32 operations (``B1_OPS`` per image,
    ``B2A_OPS``, ``B2B_OPS``)."""
    px, st = h * w, storage.itemsize
    if kernel == "poly_expansion":
        return _bound(2 * px * (in_dtype.itemsize + 5 * st), 2 * B1_OPS * px)
    if kernel == "update_equations":
        return _bound(px * (8 + 16 * st), B2A_OPS[variant] * px)
    return _bound(px * (6 * st + 16), B2B_OPS * px)


def pyramid_bound_ms(kernel: str, h: int, w: int, levels, dtype,
                     images: int = 2) -> tuple[float, str]:
    """B8's and B14's bound on ``images`` (h, w) images of ``dtype`` made
    into float32 levels (``levels``: (oh, ow, sigma) each; B14's have no
    sigma): each input byte read once, each output byte written once (B14's
    ``lk_pyramid`` writes the uint8 frames' float32 copies too).
    Operations, a product and a sum a tap, in the order that needs fewest
    (the kernel's): B8 blurs every pixel along the rows' axis (2R + 1 taps;
    on a downscale every pixel lies in some output's band), resizes the
    rows (ky a band), blurs the oh rows along x, resizes the columns (kx),
    at each level; B14 needs at each level the vertical pass at the level
    above's even rows and the horizontal one at the outputs (5 taps
    each)."""
    from transflow_tpu_torch.ops import pyramid
    nbytes = images * (h * w * dtype.itemsize
                       + sum(oh * ow * 4 for oh, ow, _ in levels))
    if kernel == "lk_pyramid":
        nbytes += images * h * w * 4
    ops, ph, pw = 0, h, w
    for oh, ow, sigma in levels:
        if kernel in ("downsample2x", "lk_pyramid"):
            ops += images * 2 * 5 * ((ph + 1) // 2 * pw + oh * ow)
            ph, pw = oh, ow
            continue
        taps = 2 * pyramid.blur_radius(sigma) + 1
        kx = pyramid.resize_weights(w, ow)[1].shape[1]
        ky = pyramid.resize_weights(h, oh)[1].shape[1]
        ops += images * 2 * (taps * h * w + ky * oh * w + taps * oh * w
                             + kx * oh * ow)
    return _bound(nbytes, ops)


def b8_replaced(images, levels) -> list:
    """The path B8 replaced, timed as its yardstick: per level and image
    the blur's two cuDNN passes (TF32 off, their pad indices and casts)
    and ``F.interpolate(antialias=True)`` (ops/image.py)."""
    from transflow_tpu_torch.ops import image
    return [image.bilinear_resize(image.gaussian_blur(x, sigma), lh, lw)
            for sigma, lh, lw in levels for x in images]


def b14_replaced(prev, nxt, levels: int) -> list:
    """The path B14's one launch replaced, timed as its yardstick: ATen's
    float32 cast of each uint8 frame, then one reduce a level below L0 for
    both images (``downsample2x_cuda``: this tree's kernel on the call
    sequence the estimator made before; ``--against`` times a parent
    tree's own reduce so)."""
    from transflow_tpu_torch.ops import pyramid
    pyr = [(prev.float().contiguous(), nxt.float().contiguous())]
    for _ in range(levels - 1):
        pyr.append(pyramid.downsample2x_cuda(pyr[-1]))
    return pyr


def _fb_compare(name: str, got, want) -> float:
    """Max |got - want|: a Farneback, Horn-Schunck or Lucas-Kanade kernel
    and its plain version keep the same rounding points and add every sum
    in one order, so they must be bit-equal."""
    if not torch.equal(got, want):
        err = (got.float() - want.float()).abs().max().item()
        raise AssertionError(f"{name} differs from its plain version: max "
                             f"|diff| {err}")
    return 0.0


def phase_farneback_kernels(device) -> list[dict]:
    """B1 (both images in one launch), B2a (radius 0 and 16) and B2b (box
    and Gaussian) against their plain versions at the four level shapes of
    a 1080p frame, in bf16 and float32 storage. B1's input is the
    storage-dtype frame at L0 and a float32 resized image below, as on the
    main path; B2a reads B1's planes of the two images and a flow with a
    fifth of its pixels moving beyond 4 px, then the Engine's pan at the
    level (``pan_flow``), B2b B2a's planes of the first. Then B8 on both
    images of a 1080p frame at ``B8_CASES`` (the pyramid of cv2's
    defaults in one launch, then each level of ``B8_LEVELS`` and
    ``B8_OFF_PATH`` alone), the frame in bf16 (the card's frame) and
    float32 (a ``fb_downscale`` image), bit-equal to its plain version,
    beside the path it replaced (``b8_replaced``) on the same images."""
    from transflow_tpu_torch.ops import farneback as fb
    from transflow_tpu_torch.ops import pyramid
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    rows = []

    def record(kernel, level, h, w, storage, variant, err, call, plain,
               bound, main, flow="random"):
        row = {"kernel": kernel, "level": level, "storage": storage,
               "variant": variant, "err": err, "flow": flow, "main": main}
        row["bound_ms"], row["bound_by"] = bound
        row["device_ms"] = device_ms(call)
        row["call_ms"] = call_ms(call)
        row["plain_ms"] = device_ms(plain, PLAIN_LAUNCHES)
        if main:  # profiled in phase 10
            row["call"] = call
        print(f"fb {kernel} {level} ({h},{w}) {str(storage)[6:]} {variant}: "
              f"max_abs_err {err:.3e} device_ms {row['device_ms']:.5f} bound "
              f"{row['bound_ms']:.5f} ({row['bound_by']}) share "
              f"{row['bound_ms'] / row['device_ms']:.1%}; call "
              f"{row['call_ms']:.4f} ms (host-inclusive); plain "
              f"{row['plain_ms']:.4f} ms")
        rows.append(row)
        return row

    for h, w, level in FB_LEVELS:
        flow = warp_flow(h, w, 4, True, gen, device)
        flows = {"random": flow, "smooth": pan_flow(h, w, device)}
        for storage in (BF16, F32):
            main = storage == BF16
            images = [torch.rand((h, w), generator=gen, device=device) * 255
                      for _ in range(2)]
            if level == "L0":
                images = [img.to(storage) for img in images]
            args = (*images, FB_POLY_N, FB_POLY_SIGMA, storage)
            polys = fb.poly_expansion_pair_cuda(*args)
            want = fb.poly_expansion_pair_plain(*args)
            err = max(_fb_compare(f"B1 {level} {storage} image {k}", got, ref)
                      for k, (got, ref) in enumerate(zip(polys, want)))
            record("poly_expansion", level, h, w, storage,
                   f"in {str(images[0].dtype)[6:]}, both images", err,
                   functools.partial(fb.poly_expansion_pair_cuda, *args),
                   functools.partial(fb.poly_expansion_pair_plain, *args),
                   fb_bound_ms("poly_expansion", h, w, storage,
                               images[0].dtype), main)
            planes = None
            for radius, (kind, f) in itertools.product((0, FB_RADIUS),
                                                       flows.items()):
                got = fb.update_equations_cuda(*polys, f, radius)
                want = fb.update_equations_plain(*polys, f, radius)
                err = _fb_compare(f"B2a {level} {storage} r{radius} {kind}",
                                  got, want)
                record("update_equations", level, h, w, storage,
                       f"radius {radius}, {kind} flow", err,
                       functools.partial(fb.update_equations_cuda, *polys,
                                         f, radius),
                       functools.partial(fb.update_equations_plain, *polys,
                                         f, radius),
                       fb_bound_ms("update_equations", h, w, storage,
                                   variant=radius), main and radius == 0,
                       kind)
                if radius == 0 and kind == "random":
                    planes = got
            for gaussian in (False, True):
                args = (planes, flow, FB_WINSIZE, gaussian)
                got = fb.aggregate_solve_cuda(*args)
                want = fb.aggregate_solve_plain(*args)
                err = _fb_compare(f"B2b {level} {storage} gaussian={gaussian}",
                                  got, want)
                if not torch.isfinite(got).all():
                    raise AssertionError(f"B2b {level}: non-finite flow")
                record("aggregate_solve", level, h, w, storage,
                       "gaussian" if gaussian else "box", err,
                       functools.partial(fb.aggregate_solve_cuda, *args),
                       functools.partial(fb.aggregate_solve_plain, *args),
                       fb_bound_ms("aggregate_solve", h, w, storage),
                       main and not gaussian)
    frame = [torch.randint(0, 256, (HEIGHT, WIDTH), generator=gen,
                           device=device).float() for _ in range(2)]
    for dtype in (BF16, F32):
        # the card's frame is uint8 in bf16; a downscaled image is float32
        images = [x.to(dtype) if dtype == BF16 else
                  x + torch.rand(x.shape, generator=gen, device=device)
                  for x in frame]
        for level, cases in B8_CASES:
            main = dtype == BF16 and level == "pyramid"
            levels = [(sigma, h, w) for h, w, _, sigma in cases]
            args = (images, levels)
            got = pyramid.pyramid_levels_cuda(*args)
            want = pyramid.pyramid_levels_plain(*args)
            err = max(_fb_compare(f"B8 {level} {dtype} {lh}x{lw} image {k}",
                                  g, r)
                      for (_, lh, lw), outs, refs in zip(levels, got, want)
                      for k, (g, r) in enumerate(zip(outs, refs)))
            if not all(torch.isfinite(g).all() for outs in got for g in outs):
                raise AssertionError(f"B8 {level}: non-finite level")
            row = record("pyramid_levels", level, HEIGHT, WIDTH, dtype,
                         f"in {str(dtype)[6:]}, both images, "
                         f"{len(levels)} level(s), sigma "
                         f"{', '.join(str(s) for s, _, _ in levels)}",
                         err,
                         functools.partial(pyramid.pyramid_levels_cuda,
                                           *args),
                         functools.partial(pyramid.pyramid_levels_plain,
                                           *args),
                         pyramid_bound_ms("pyramid_levels", HEIGHT, WIDTH,
                                          [(h, w, sigma)
                                           for sigma, h, w in levels],
                                          dtype), main)
            replaced = functools.partial(b8_replaced, *args)
            row["replaced_ms"] = device_ms(replaced, PLAIN_LAUNCHES * 10)
            if main:  # profiled in phase 10
                row["replaced_call"] = replaced
            plans = [pyramid.level_plan(HEIGHT, WIDTH, h, w,
                                        pyramid.blur_radius(sigma),
                                        dtype.itemsize)
                     for sigma, h, w in levels]
            print(f"fb pyramid_levels {level}: the path it replaced (two "
                  f"cuDNN passes and F.interpolate an image and level) "
                  f"{row['replaced_ms']:.5f} ms; launches "
                  f"{pyramid.launches(HEIGHT, WIDTH, levels)}; (kind, tile "
                  f"rows, tile columns, segment, slab, staged rows, shared "
                  f"bytes) a level {plans}")
    return rows


def aten_ops(fn) -> int:
    """The ATen ops of one call of ``fn`` that are no views: on the card,
    about the kernels a plain PyTorch function launches."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountOps(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops += not func.is_view
            return func(*args, **(kwargs or {}))

    with CountOps() as counter:
        fn()
    return counter.ops


def phase_draw(device) -> dict:
    """The random reset's 1080x1920 threefry draw on the card against the
    CPU's, with its time and its launches (ATen ops that run a kernel)."""
    from transflow_tpu_torch import prng
    key = prng.split(prng.key(SEED))[1]
    got = prng.uniform(key, (HEIGHT, WIDTH), device)
    same = torch.equal(got.cpu(), prng.uniform(key, (HEIGHT, WIDTH)))
    ops = aten_ops(lambda: prng.uniform(key, (HEIGHT, WIDTH), device))
    ms = device_ms(lambda: prng.uniform(key, (HEIGHT, WIDTH), device), 20)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(20):
        prng.uniform(key, (HEIGHT, WIDTH), device)
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - start) / 20
    print(f"draw {HEIGHT}x{WIDTH} threefry uniform cuda vs cpu: "
          f"{'bit-equal' if same else 'DIFFER'}; {ms:.4f} ms (device_ms) "
          f"{host_ms:.4f} ms (host, synced) and {ops} launches per "
          "frame (one random layer)")
    if not same:
        raise AssertionError("the threefry draw differs between the card "
                             "and the CPU")
    return {"ms": ms, "host_ms": host_ms, "launches": ops}


# the compositor kernels' names in csrc/compositor.cu (phase C)
C_KERNEL_NAMES = {"K0": "leave_empty_kernel", "K1": "layer_update_kernel",
                  "K2": "composite_kernel"}
# integer operations of K1's threefry draw a pixel (20 rounds of an add, a
# rotate and a xor, 5 key injections of three, the float): the table has
# no integer rate, so they are counted at the f32 peak; bytes bind anyway
C_DRAW_OPS = 100


def comp_k1_bound_ms(params, state: dict, flow, new: dict, key
                     ) -> tuple[float, str]:
    """K1's bound on these inputs: the bytes the layer's new state needs,
    pixel by pixel, with every output written once. A pixel the random
    reset takes (``reset``) gets its own coordinates and alpha 1, and its
    source from the ``reset_source`` plane where that holds one (then it
    needs nothing of the old state or the flow). Otherwise: the flow; a
    target's positions and source read at its source pixel, another
    pixel's its own; its own alpha where it is no target and no
    leave-empty mark zeroes it, or where the target test reads it; at the
    source pixel of a moving pixel the alpha where the test or the new
    alpha reads it and ``mask_src``; ``mask_dst`` where it moves; the
    leave-empty mark where it is no target. The regather reads the
    selected source's pixmap (its alpha byte only where no later
    3-channel source overwrites it) and the old rgb where no source shows
    the pixel, the old alpha only where the layer has no 3-channel
    source. The draw's operations in random mode."""
    from transflow_tpu_torch import prng
    from transflow_tpu_torch.compositor.core import movement_targets
    from transflow_tpu_torch.ops.compositor import leave_empty_sources_plain
    cfg = params.cfg
    h, w = params.height, params.width
    n = h * w

    def count(mask) -> int:
        return int(mask.sum())

    psz, out_psz = (state["pos_i"].element_size(),
                    new["pos_i"].element_size())
    # the writes: the new positions, alpha, source and rgba
    nbytes = n * (2 * out_psz + 2 + 4)
    none = torch.zeros((h, w), dtype=torch.bool, device=flow.device)
    reset = covered = none
    if cfg.reset_mode == "random":
        reset = prng.uniform(key, (h, w), flow.device) < params.reset_factor
        if cfg.reset_source:
            covered = reset & (params.last_source_plane != 255)
            nbytes += count(reset)
    if params.reset_factor is not None and params.reset_factor.dim() == 2:
        nbytes += 4 * n
    live = ~covered
    if cfg.classname == "sum":
        nbytes += 8 * count(~reset) + 2 * psz * count(~reset)
        nbytes += count(~reset) + count(live)  # own alpha, own source
    else:
        _, target, moving, *_ = movement_targets(params, state["alpha"],
                                                 flow)
        target, moving = target & live, moving & live
        marked = none
        if cfg.moving_pixels_leave_empty_spot:
            marked = leave_empty_sources_plain(params, state, flow)
            nbytes += count(~target & ~reset)
        filled_test = not (cfg.pixels_can_move_to_empty_spot
                           and cfg.pixels_can_move_to_filled_spot)
        nbytes += 8 * count(live)
        nbytes += 2 * psz * count(~reset & live)  # own or gathered pos
        nbytes += count(live)  # own or gathered source
        nbytes += count((~target & ~reset & ~marked & live)
                        | (moving if filled_test else none))
        gathered_alpha = target & ~reset
        if not cfg.transparent_pixels_can_move:
            gathered_alpha = gathered_alpha | moving
        nbytes += count(gathered_alpha)
        nbytes += count(moving) * ((params.mask_src is not None)
                                   + (params.mask_dst is not None))
    shown = new["alpha"] != 0
    shown_any = none
    last3 = max((s for s, c in enumerate(params.channel_counts) if c == 3),
                default=-1)
    for s, channels in enumerate(params.channel_counts):
        sel = shown & (new["source"] == s)
        shown_any = shown_any | sel
        nbytes += (3 + (channels == 4 and s > last3)) * count(sel)
    nbytes += 3 * count(~shown_any)
    if last3 < 0:
        nbytes += count(~shown_any)
    ops = C_DRAW_OPS * n if cfg.reset_mode == "random" else 0
    return _bound(nbytes, ops)


def comp_k0_bound_ms(params, state: dict, flow, marks) -> tuple[float, str]:
    """K0's bound: the flow read a pixel; where a pixel moves, the alpha
    at its source where the target test reads it, ``mask_src`` there and
    ``mask_dst`` at the pixel where set, its own alpha where the test
    reads it; one byte written a marked source."""
    from transflow_tpu_torch.compositor.core import movement_targets
    cfg = params.cfg
    n = params.height * params.width
    _, _, moving, *_ = movement_targets(params, state["alpha"], flow)
    per_moving = ((not cfg.transparent_pixels_can_move)
                  + (params.mask_src is not None)
                  + (params.mask_dst is not None)
                  + (not (cfg.pixels_can_move_to_empty_spot
                          and cfg.pixels_can_move_to_filled_spot)))
    nbytes = 8 * n + int(moving.sum()) * per_moving + int(marks.sum())
    return _bound(nbytes, 0)


def comp_k2_bound_ms(params_list, h: int, w: int) -> tuple[float, str]:
    """K2's bound: each layer's rgb and alpha read (4 bytes a pixel), its
    alpha mask read and its new rgba (or introduction's alpha) written
    where set, the image written."""
    per_pixel = 3
    for params in params_list:
        per_pixel += 4
        if params.mask_alpha is not None:
            per_pixel += 4 + (1 if params.cfg.classname == "introduction"
                              else 4)
    return _bound(per_pixel * h * w, 0)


def phase_compositor_kernels(device, fb_run: dict, t_run: dict
                             ) -> list[dict]:
    """Phase C: K0, K1 and K2 against their plain versions at 1080x1920
    on the main path's inputs, bit-equal, with ``device_ms``, the bound,
    its share, ``call_ms`` and the plain version's time: K1 on phase F's
    Engine state and pan flow (its moveref layer, random reset 0.01) and
    on a random flow; K0, then K0 + K1, on the same layer with
    leave-empty; K2 over phase F's layer and over phase T's four masked
    layers."""
    from transflow_tpu_torch import prng
    from transflow_tpu_torch.compositor.core import make_layer_params
    from transflow_tpu_torch.config import LayerConfig
    from transflow_tpu_torch.ops import compositor as ck
    from transflow_tpu_torch.ops.image import clip_to_frame
    engine = fb_run["engine"]
    params, state = engine.layer_params[0], engine.comp_state[0]
    pixmaps = fb_run["pixmaps"][0]
    pan = fb_run["call_flows"][-1].contiguous()
    gen = torch.Generator(device=device).manual_seed(SEED)
    random_flow = clip_to_frame(torch.randn((HEIGHT, WIDTH, 2),
                                            generator=gen, device=device) * 8)
    key = prng.split(prng.key(SEED), 3)[1]
    leave = make_layer_params(
        [LayerConfig(0, reset_mode="random", reset_random_factor=0.01,
                     moving_pixels_leave_empty_spot=True)],
        HEIGHT, WIDTH, {0: [(3, None)]}, device=device)[0]
    rows = []

    def add(kernel, name, err, bound, fn, plain, launches, extra=""):
        bound_ms, by = bound
        row = {"kernel": kernel, "input": name, "err": err,
               "bound_ms": bound_ms, "bound_by": by, "launches": launches,
               "plain_ops": aten_ops(plain),
               "device_ms": device_ms(fn), "call_ms": call_ms(fn),
               "plain_ms": device_ms(plain, PLAIN_LAUNCHES, warmup=1),
               "call": fn}
        print(f"{kernel} {HEIGHT}x{WIDTH} {name}: bit-equal to plain{extra};"
              f" {launches} launches a call against the plain version's "
              f"{row['plain_ops']} ATen ops; device_ms "
              f"{row['device_ms']:.5f}, bound {bound_ms:.5f} ({by}), share "
              f"{bound_ms / row['device_ms']:.1%}, call {row['call_ms']:.4f}"
              f" (host-inclusive), plain {row['plain_ms']:.4f}")
        rows.append(row)

    for kernel, name, p, flow in (("K1", "F pan", params, pan),
                                  ("K1", "random flow", params, random_flow),
                                  ("K1", "F pan leave-empty (K0 + K1)",
                                   leave, pan)):
        got = ck.layer_update_cuda(p, state, flow, pixmaps, key)
        want = ck.layer_update_plain(p, state, flow, pixmaps, key)
        torch.cuda.synchronize()
        diff = [k for k in want if not torch.equal(got[k], want[k])]
        if diff:
            raise AssertionError(f"{kernel} {name}: {diff} differ from plain")
        add(kernel, name, 0.0, comp_k1_bound_ms(p, state, flow, want,
                                                 key),
            lambda p=p, f=flow: ck.layer_update_cuda(p, state, f, pixmaps,
                                                     key),
            lambda p=p, f=flow: ck.layer_update_plain(p, state, f, pixmaps,
                                                      key),
            1 + p.cfg.moving_pixels_leave_empty_spot,
            f" ({int((want['alpha'] == 0).sum())} empty pixels)")
    marks = torch.zeros((HEIGHT, WIDTH), dtype=torch.uint8, device=device)
    got = ck.leave_empty_sources_cuda(leave, state, pan, out=marks).bool()
    want = ck.leave_empty_sources_plain(leave, state, pan)
    if not torch.equal(got, want):
        raise AssertionError("K0 F pan: the marks differ from plain")
    add("K0", "F pan", 0.0, comp_k0_bound_ms(leave, state, pan, want),
        lambda: ck.leave_empty_sources_cuda(leave, state, pan, out=marks),
        lambda: ck.leave_empty_sources_plain(leave, state, pan), 1,
        f" ({int(want.sum())} sources marked)")
    bg = torch.tensor([255, 255, 255], dtype=torch.uint8, device=device)
    t_engine = t_run["engine"]
    for name, layers, states in (
            ("F layer", [params], [state]),
            ("T's four masked layers", t_engine.layer_params,
             t_engine.comp_state)):
        got_states, got = ck.composite_cuda(layers, states, bg, HEIGHT,
                                            WIDTH)
        want_states, want = ck.composite_plain(layers, states, bg, HEIGHT,
                                               WIDTH)
        torch.cuda.synchronize()
        same = torch.equal(got, want) and all(
            torch.equal(a[k], b[k]) for a, b in zip(got_states, want_states)
            for k in b)
        if not same:
            raise AssertionError(f"K2 {name}: differs from plain")
        add("K2", name, 0.0, comp_k2_bound_ms(layers, HEIGHT, WIDTH),
            lambda ls=layers, ss=states: ck.composite_cuda(ls, ss, bg,
                                                           HEIGHT, WIDTH),
            lambda ls=layers, ss=states: ck.composite_plain(ls, ss, bg,
                                                            HEIGHT, WIDTH),
            1)
    return rows


def phase_equivalence(device) -> None:
    """Phase 9 in float32 with TF32 off; the caller's settings come back
    after it, so that phase 10 profiles the main path's bf16 network."""
    saved = (os.environ.get("TRANSFLOW_LITEFLOWNET_BF16"),
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    os.environ["TRANSFLOW_LITEFLOWNET_BF16"] = "0"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        _equivalence(device)
    finally:
        if saved[0] is None:
            os.environ.pop("TRANSFLOW_LITEFLOWNET_BF16", None)
        else:
            os.environ["TRANSFLOW_LITEFLOWNET_BF16"] = saved[0]
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved[1:]


def _equivalence(device) -> None:
    from transflow_tpu_torch import prng
    from transflow_tpu_torch.compositor.core import (build_compositor,
                                                     make_layer_params)
    from transflow_tpu_torch.config import LayerConfig
    from transflow_tpu_torch.flow.transforms import clip_to_frame
    h, w = 128, 192
    frames = panned_frames(EQUIV_FRAMES + 1, h, w, "cpu")
    flows = {}
    for dev in (device, "cpu"):
        model = flagship_model(h, w, dev)
        _, got = run_frames(model, frames.to(dev),
                            model.default_pixmaps(SEED), prng.key(SEED))
        flows[dev] = torch.stack(got).cpu()
    err = (flows[device] - flows["cpu"]).abs().max().item()
    print(f"equivalence {h}x{w} f32 slice cuda vs cpu: max |dflow| "
          f"{err:.3e} over {EQUIV_FRAMES} frames")
    if not err <= EQUIV_FLOW_ATOL:
        raise AssertionError(f"CUDA and CPU flows differ by {err}")

    # Farneback in float32 storage: the kernels on the card, their plain
    # versions on the CPU; held to the CPU tests' bar against JAX
    from transflow_tpu_torch.flow.estimators.farneback import farneback
    saved = os.environ.get("TRANSFLOW_FARNEBACK_BF16")
    os.environ["TRANSFLOW_FARNEBACK_BF16"] = "0"
    try:
        gray = gray_frames(EQUIV_FRAMES + 1, h, w, "cpu")
        fb_flows = {dev: torch.stack([
            farneback(gray[k + 1].to(dev), gray[k].to(dev)).cpu()
            for k in range(EQUIV_FRAMES)]) for dev in (device, "cpu")}
    finally:
        if saved is None:
            os.environ.pop("TRANSFLOW_FARNEBACK_BF16")
        else:
            os.environ["TRANSFLOW_FARNEBACK_BF16"] = saved
    diff = fb_flows[device] - fb_flows["cpu"]
    mse = float((diff ** 2).mean())
    psnr = 10 * np.log10(8.0 ** 2 / mse) if mse else float("inf")
    print(f"equivalence {h}x{w} f32 farneback cuda vs cpu: PSNR {psnr:.2f} "
          f"dB at an 8 px peak, max |dflow| {diff.abs().max().item():.3e} "
          f"over {EQUIV_FRAMES} pairs")
    if not psnr >= FB_EQUIV_PSNR:
        raise AssertionError(f"CUDA and CPU Farneback flows: {psnr} dB")

    # Horn-Schunck (bit-equal: B9's arithmetic is exact, B10 rounds as its
    # plain version) and Lucas-Kanade (the CPU tests' 1e-4 against JAX:
    # its Scharr derivatives run in cuDNN on the card)
    from transflow_tpu_torch.flow.estimators.horn_schunck import (
        horn_schunck_counted)
    from transflow_tpu_torch.flow.estimators.lucas_kanade import (
        lucas_kanade)
    gray = gray_frames(EQUIV_FRAMES + 1, h, w, "cpu")
    classic = {}
    for dev in (device, "cpu"):
        flow, hs_flows, lk_flows = None, [], []
        for k in range(EQUIV_FRAMES):
            a, b = gray[k + 1].to(dev), gray[k].to(dev)
            flow, iters = horn_schunck_counted(a, b, flow)
            hs_flows.append((flow.cpu(), int(iters)))
            lk_flows.append(lucas_kanade(a, b, step=4).cpu())
        classic[dev] = (hs_flows, lk_flows)
    (hs_dev, lk_dev), (hs_cpu, lk_cpu) = classic[device], classic["cpu"]
    if not all(torch.equal(f, g) and i == j
               for (f, i), (g, j) in zip(hs_dev, hs_cpu)):
        raise AssertionError("CUDA and CPU Horn-Schunck flows differ")
    lk_err = max((f - g).abs().max().item() for f, g in zip(lk_dev, lk_cpu))
    print(f"equivalence {h}x{w} horn-schunck cuda vs cpu: bit-equal over "
          f"{EQUIV_FRAMES} warm-started pairs (iterations "
          f"{[i for _, i in hs_dev]}); lukas-kanade.json: max |dflow| "
          f"{lk_err:.3e}")
    if not lk_err <= LK_EQUIV_ATOL:
        raise AssertionError(f"CUDA and CPU Lucas-Kanade flows: {lk_err}")

    # the compositor on one flow: large integer and half-integer motion
    # on top of the estimated flow, the random reset drawn on each device
    # from one key chain
    rng = np.random.default_rng(SEED)
    cfg = LayerConfig(0, reset_mode="random", reset_random_factor=0.05,
                      moving_pixels_leave_empty_spot=True)
    results = {}
    for dev in (device, "cpu"):
        params = make_layer_params([cfg], h, w, {0: [(3, None)]},
                                   device=dev)
        init_fn, step_fn = build_compositor(params, h, w, device=dev)
        state = init_fn()
        pixmap = torch.from_numpy(
            np.random.default_rng(SEED).integers(0, 256, (h, w, 3),
                                                 np.uint8)).to(dev)
        rng = np.random.default_rng(SEED)
        key = prng.key(SEED)
        for idx in range(EQUIV_FRAMES):
            motion = (rng.integers(-6, 7, (h, w, 2))
                      + 0.5 * rng.integers(0, 2, (h, w, 2)))
            flow = clip_to_frame(flows["cpu"][idx].to(dev)
                                 + torch.from_numpy(motion).float().to(dev))
            key, sub = prng.split(key)
            state, rgb = step_fn(state, flow, ((pixmap,),), sub, ((0,),))
        results[dev] = ({k: v.cpu() for k, v in state[0].items()},
                        rgb.cpu())
    (s_dev, rgb_dev), (s_cpu, rgb_cpu) = results[device], results["cpu"]
    for key in s_cpu:
        if not torch.equal(s_dev[key], s_cpu[key]):
            raise AssertionError(f"compositor state {key!r} differs")
    if not torch.equal(rgb_dev, rgb_cpu):
        raise AssertionError("compositor frames differ")
    print(f"equivalence compositor cuda vs cpu: states and frames "
          f"bit-equal over {EQUIV_FRAMES} frames")


def phase_kernel_time(rows, a2_rows, warp_rows, b7_rows, up_rows,
                      reg_rows, b18_rows, fb_rows, b5_rows, h_rows,
                      c_rows) -> None:
    """``kernel_ms`` of every row that phases 6, 7, 7b, 7c, 8, B, T, H and
    C left a call in; A3's and B7's beside ``F.grid_sample``'s, B16's beside
    ``F.conv_transpose2d``'s, B18's beside the ops it replaced (every
    device event of ``b18_replaced``); B8's and B14's
    beside the path each replaced (every device event of it); B5's over
    every device event of a call (its two kernels); K0-K2's of the row's
    kernel alone (the leave-empty K1 row: K1's, without K0's)."""
    for row in rows + a2_rows:
        if "call" not in row:
            continue
        row["kernel_ms"] = kernel_ms(row.pop("call"), "corr7x7")
        name = (f"a2 {row['level']} x{row['shards']}" if "shards" in row
                else f"corr {row['level']} {_pair(*row['pair'])}")
        print(f"kernel time {name}: {_ms_text(row['kernel_ms'])} "
              f"(torch.profiler, per call) against device_ms "
              f"{row['device_ms']:.5f}")
    for row in warp_rows:
        if "call" not in row:
            continue
        row["kernel_ms"] = kernel_ms(row.pop("call"), "bounded_backwarp")
        # every device event of the library call: cuDNN's sampler (whose
        # name is cuDNN's) and any copy it makes
        row["library_kernel_ms"] = kernel_ms(row.pop("library_call"), "")
        print(f"kernel time warp {row['level']} bf16 within: A3 "
              f"{_ms_text(row['kernel_ms'])}, grid_sample "
              f"{_ms_text(row['library_kernel_ms'])} (torch.profiler, per "
              f"call) against device_ms A3 {row['device_ms']:.5f}, "
              f"grid_sample {row['library_ms']:.5f}")
    for row in b7_rows:
        row["kernel_ms"] = kernel_ms(row.pop("call"), "exact_backwarp")
        row["library_kernel_ms"] = kernel_ms(row.pop("library_call"), "")
        share = ("not measured" if row["kernel_ms"] is None
                 else f"{row['bound_ms'] / row['kernel_ms']:.1%}")
        print(f"kernel time B7 {row['level']} {row['kind']} "
              f"{str(row['dtype'])[6:]}: {_ms_text(row['kernel_ms'])}, "
              f"grid_sample {_ms_text(row['library_kernel_ms'])} "
              f"(torch.profiler, per call) against device_ms "
              f"{row['device_ms']:.5f} and bound {row['bound_ms']:.5f} "
              f"({row['bound_by']}): share {share}")
    for row in up_rows + reg_rows:
        kernel = row["kernel"]
        row["kernel_ms"] = kernel_ms(row.pop("call"), f"{kernel}_kernel")
        library = ""
        if "library_call" in row:
            row["library_kernel_ms"] = kernel_ms(row.pop("library_call"), "")
            library = (f", conv_transpose2d "
                       f"{_ms_text(row['library_kernel_ms'])}")
        share = ("not measured" if row["kernel_ms"] is None
                 else f"{row['bound_ms'] / row['kernel_ms']:.1%}")
        dtypes = (str(row["dtype"])[6:] if "dtype" in row else
                  f"dist {str(row['dist'])[6:]} flow {str(row['flow'])[6:]} "
                  f"{row['kind']}")
        print(f"kernel time {kernel} {row['level']} {dtypes}: "
              f"{_ms_text(row['kernel_ms'])}{library} (torch.profiler, per "
              f"call) against device_ms {row['device_ms']:.5f} and bound "
              f"{row['bound_ms']:.5f} ({row['bound_by']}): share {share}")
    for row in b18_rows:
        if "call" not in row:
            continue
        row["kernel_ms"] = kernel_ms(row.pop("call"), "conv_epilogue")
        share = ("not measured" if row["kernel_ms"] is None
                 else f"{row['bound_ms'] / row['kernel_ms']:.1%}")
        print(f"kernel time conv_epilogue {row['level']} {row['shape']}: "
              f"{_ms_text(row['kernel_ms'])} (torch.profiler, per call) "
              f"against device_ms {row['device_ms']:.5f} and bound "
              f"{row['bound_ms']:.5f} ({row['bound_by']}): share {share}"
              f"{_replaced_text(row)}")
    for row in fb_rows:
        if "call" not in row:
            continue
        row["kernel_ms"] = kernel_ms(row.pop("call"),
                                     f"{row['kernel']}_kernel")
        print(f"kernel time fb {row['kernel']} {row['level']} bf16 "
              f"{row['variant']}: {_ms_text(row['kernel_ms'])} "
              f"(torch.profiler, per call) against device_ms "
              f"{row['device_ms']:.5f} and bound {row['bound_ms']:.5f} "
              f"({row['bound_by']}){_replaced_text(row)}")
    for row in h_rows:
        row["kernel_ms"] = kernel_ms(row.pop("call"),
                                     H_KERNEL_NAMES[row["kernel"]])
        print(f"kernel time classic {row['kernel']} {row['level']}: "
              f"{_ms_text(row['kernel_ms'])} (torch.profiler, per call) "
              f"against device_ms {row['device_ms']:.5f} and bound "
              f"{row['bound_ms']:.5f} ({row['bound_by']})"
              f"{_replaced_text(row)}")
    for row in b5_rows:
        row["kernel_ms"] = kernel_ms(row.pop("call"), "")
        print(f"kernel time B5 {row['flow']}: {_ms_text(row['kernel_ms'])} "
              f"(torch.profiler, per call, both kernels) "
              f"against device_ms {row['device_ms']:.5f} and bound "
              f"{row['bound_ms']:.5f} ({row['bound_by']})")
    for row in c_rows:
        row["kernel_ms"] = kernel_ms(row.pop("call"),
                                     C_KERNEL_NAMES[row["kernel"]])
        share = ("not measured" if row["kernel_ms"] is None
                 else f"{row['bound_ms'] / row['kernel_ms']:.1%}")
        print(f"kernel time {row['kernel']} {row['input']}: "
              f"{_ms_text(row['kernel_ms'])} (torch.profiler, per call) "
              f"against device_ms {row['device_ms']:.5f} and bound "
              f"{row['bound_ms']:.5f} ({row['bound_by']}): share {share}")


def _ms_text(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.5f} ms"


def _replaced_text(row: dict) -> str:
    """The kernel time of the path a row's kernel replaced (every device
    event of a call), where the row has one."""
    if "replaced_call" not in row:
        return ""
    row["replaced_kernel_ms"] = kernel_ms(row.pop("replaced_call"), "")
    return (f"; the path it replaced {_ms_text(row['replaced_kernel_ms'])} "
            f"(device_ms {row['replaced_ms']:.5f})")


def host_syncs(run: dict, calls: int) -> float:
    """Host waits for the card per frame in the Engine of ``run`` over its
    next ``calls`` frames (``profiling.host_sync_sites``). Prints the
    Python stack of each distinct place that waits."""
    from transflow_tpu_torch.profiling import host_sync_sites
    fno0 = run["next_fno"]

    def steps():
        for k in range(calls):
            run["step"](fno0 + k)

    sites = host_sync_sites(steps)
    run["next_fno"] = fno0 + calls
    for site in dict.fromkeys(sites):
        print(f"host sync ({sites.count(site)} of {len(sites)}) at:\n"
              f"{site.rstrip()}")
    return len(sites) / calls


PROFILE_TOP = 16  # kernel names in the Engine's device time by name
# ATen ops of the pyramid's path before B8 (cuDNN's convolutions, the pad
# indices' gathers): phase F's profile must show none
F_REPLACED_OPS = ("aten::convolution", "aten::cudnn_convolution",
                  "aten::index_select")


def engine_profile(name: str, run: dict, calls: int, card: str,
                   unit: str = "process_frame calls") -> dict:
    """The Engine of ``run`` over its next ``calls`` frames under
    ``torch.profiler``: device events (kernels, copies, sets), busy time
    (their intervals merged) and idle share per frame, against the host
    clock around the window (which ends in a synchronize); and the device
    time per frame by event name, the ``PROFILE_TOP`` largest; the result
    also holds the device events' names and the ATen ops' names."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fno0 = run["next_fno"]
    run["next_fno"] = fno0 + calls
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for k in range(calls):
            run["step"](fno0 + k)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - start) / calls
    device_events = [e for e in prof.events()
                     if getattr(e, "device_type", None) == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in device_events)
    by_name = {}
    for e in device_events:
        entry = by_name.setdefault(e.name, [0.0, 0])
        entry[0] += e.time_range.elapsed_us() / 1e3 / calls
        entry[1] += 1
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    result = {"events": len(spans) / calls, "busy_ms": busy / 1e3 / calls,
              "wall_ms": wall_ms, "device_names": set(by_name),
              "by_name": {k: (ms, n / calls)
                          for k, (ms, n) in by_name.items()},
              "aten_ops": {e.name for e in prof.events()
                           if e.name.startswith("aten::")}}
    if not spans:
        print(f"profile {name}: no device events (busy share not measured)")
        return result
    result["idle"] = 1 - result["busy_ms"] / wall_ms
    print(f"profile {name} ({calls} {unit}, torch.profiler): "
          f"{result['events']:.1f} device events, {result['busy_ms']:.3f} ms "
          f"busy, {wall_ms:.3f} ms host clock per frame: busy share "
          f"{1 - result['idle']:.1%}, idle {result['idle']:.1%} on {card}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:PROFILE_TOP]
    print(f"profile {name}: device time per frame by name, the "
          f"{len(top)} largest of {len(by_name)} names (ms, events per "
          "frame):")
    for k, (ms, n) in top:
        print(f"  {ms:.5f} ms, {n / calls:g} events: {k[:120]}")
    comp = {c: [sum(v[i] for k, v in by_name.items() if pattern in k)
                for i in (0, 1)]
            for c, pattern in C_KERNEL_NAMES.items()}
    result["compositor"] = {c: v[0] for c, v in comp.items()}
    print(f"profile {name}: the compositor's kernels per frame: "
          + ", ".join(f"{c} {ms:.5f} ms in {n / calls:g} events"
                      for c, (ms, n) in comp.items()))
    return result


# the port's LiteFlowNet kernels in a profile, by a part of their names
LFN_KERNEL_NAMES = {"A1": "corr7x7", "A3": "bounded_backwarp_kernel",
                    "B7": "exact_backwarp_kernel",
                    "B16": "upsample2x_phases_kernel",
                    "B17": "reg_apply_kernel",
                    "B18": "conv_epilogue"}


def epilogue_audit(fn) -> dict:
    """The ops of one call of ``fn`` that B18 replaced, by name: bias adds
    (an ``add`` of a one-dimensional operand to a 4-D tensor), leaky
    ReLUs by input dtype, and casts of a parameter (``_to_copy`` of an
    ``nn.Parameter``); the correlation's float32 leaky ReLUs stay."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Audit(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.found = {"bias adds": 0, "parameter casts": 0}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            if name in ("add", "add_") and len(tensors) == 2 and \
                    sorted(t.dim() for t in tensors) == [1, 4]:
                self.found["bias adds"] += 1
            if name.startswith("leaky_relu"):
                key = f"leaky_relu {str(tensors[0].dtype)[6:]}"
                self.found[key] = self.found.get(key, 0) + 1
            if name == "_to_copy" and \
                    isinstance(tensors[0], torch.nn.Parameter):
                self.found["parameter casts"] += 1
            return func(*args, **(kwargs or {}))

    with Audit() as audit:
        fn()
    return audit.found


def lfn_profile(name: str, run: dict, card: str) -> dict:
    """The LiteFlowNet Engine of ``run`` a frame: the ATen ops of one
    ``process_frame`` call (views left out: about the launches of its plain
    ops), the ops B18 replaced in the next (``epilogue_audit``), then
    ``engine_profile`` over ``LFN_PROFILE_CALLS`` calls and the device time
    a frame of each of the port's LiteFlowNet kernels
    (``LFN_KERNEL_NAMES``) and of everything else."""
    fno = run["next_fno"]
    run["next_fno"] = fno + 2
    ops = aten_ops(lambda: run["step"](fno))
    print(f"profile {name}: {ops} ATen ops a frame (one process_frame "
          f"call, views left out) on {card}")
    audit = epilogue_audit(lambda: run["step"](fno + 1))
    print(f"profile {name}: the ops B18 replaced a frame: "
          + ", ".join(f"{k} {n}" for k, n in audit.items()))
    profile = engine_profile(name, run, LFN_PROFILE_CALLS, card)
    profile["aten_ops_per_frame"] = ops
    profile["audit"] = audit
    if not profile["by_name"]:
        return profile
    ours = 0.0
    for label, pattern in LFN_KERNEL_NAMES.items():
        ms, n = (sum(v[i] for k, v in profile["by_name"].items()
                     if pattern in k) for i in (0, 1))
        ours += ms
        print(f"profile {name}: {label} {ms:.5f} ms in {n:g} events a frame")
    print(f"profile {name}: the port's LiteFlowNet kernels {ours:.5f} ms, "
          f"every other device event {profile['busy_ms'] - ours:.5f} ms "
          f"of {profile['busy_ms']:.3f} ms busy a frame on {card}")
    return profile


def lfn_profile_only(device, card: str) -> None:
    """``--lfn-profile``: phase 4's bound-0 Engine alone: after a warm-up
    its ms/frame over ``ENGINE_FRAMES`` ``process_frame`` calls, then its
    host syncs, ATen ops and profile a frame. It uses nothing that
    the package lacked before kernels B16 and B17, so this script copied
    into another tree's checkout profiles that tree's package."""
    from transflow_tpu_torch._device import kernel_library
    os.environ["TRANSFLOW_LITEFLOWNET_RANDOM"] = "1"
    lib = kernel_library()
    print(f"build: {lib.path.name} in {lib.build_seconds:.2f} s")
    warmup = ENGINE_WARMUP + ENGINE_CALLS
    frames = panned_frames(1 + warmup + ENGINE_FRAMES + LFN_SYNC_CALLS + 2
                           + LFN_PROFILE_CALLS, HEIGHT, WIDTH, device)
    pixmap = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 256, (HEIGHT, WIDTH, 3), dtype=np.uint8)).to(device)
    engine, source = make_engine(device, frames, lfn_config(0))
    items = iter(source)

    def step(fno):
        engine.process_frame([next(items)], ((pixmap,),), fno / 30.0,
                             ((fno,),))

    for fno in range(warmup):
        step(fno)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for fno in range(warmup, warmup + ENGINE_FRAMES):
        step(fno)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - start) / ENGINE_FRAMES
    print(f"liteflownet engine lfn_warp_bound=0: {ms:.2f} ms/frame over "
          f"{ENGINE_FRAMES} process_frame calls after {warmup} (host clock "
          f"to a synchronize) on {card}")
    run = {"step": step, "next_fno": warmup + ENGINE_FRAMES}
    syncs = host_syncs(run, LFN_SYNC_CALLS)
    print(f"liteflownet engine lfn_warp_bound=0: {syncs:g} host syncs per "
          f"frame ({LFN_SYNC_CALLS} process_frame call) on {card}")
    lfn_profile("liteflownet engine lfn_warp_bound=0", run, card)


def build_others(csrcs: list[Path], mine: list[dict]) -> list[ctypes.CDLL]:
    """The ``OTHER_SOURCES`` each of other trees' ``csrcs`` has, built with
    the package's nvcc flags (one nvcc per source, all at once) into one
    library per tree under ``_build/``, with the argument types of the C
    entries each has (``_SIGNATURES``, or ``OTHER_SIGNATURES`` for entries
    this tree no longer has). Prints ptxas's report of every instantiation
    that differs from this tree's (``mine``)."""
    from transflow_tpu_torch._device import (BUILD_DIR, NVCC_FLAGS,
                                             _SIGNATURES, nvcc_path)
    paths, jobs = [], {}
    for csrc in csrcs:
        sources = [csrc / name for name in OTHER_SOURCES
                   if (csrc / name).exists()]
        digest = hashlib.sha256()
        for source in sources:
            digest.update(source.read_bytes())
        path = BUILD_DIR / f"other-{digest.hexdigest()[:16]}.so"
        paths.append(path)
        if path.exists() or path in jobs:
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        objects = [path.with_name(f"{path.stem}-{s.stem}.o") for s in sources]
        jobs[path] = (sources, objects, [
            subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-c", "-o", str(obj),
                              str(src)], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objects)])
    known = {(r["name"], r["registers"], r["smem"], r["spills"]) for r in mine}
    for path, (sources, objects, procs) in jobs.items():
        logs = [proc.communicate()[0] for proc in procs]
        for src, proc, log in zip(sources, procs, logs):
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        for r in ptxas_reports("\n".join(logs)):
            if (r["name"], r["registers"], r["smem"], r["spills"]) not in known:
                print(f"  {sources[0].parent} ptxas {r['name']}: "
                      f"{r['registers']} registers, {r['smem']} bytes smem, "
                      f"spills {r['spills']}")
        link = subprocess.run([nvcc_path(), "-shared", "-o", str(path),
                               *map(str, objects)], capture_output=True,
                              text=True, check=False)
        for obj in objects:
            obj.unlink(missing_ok=True)
        if link.returncode:
            raise RuntimeError(f"link failed:\n{link.stdout}{link.stderr}")
    libs = []
    for path in paths:
        lib = ctypes.CDLL(str(path))
        for name, argtypes in (_SIGNATURES | OTHER_SIGNATURES).items():
            if hasattr(lib, name):
                getattr(lib, name).argtypes = argtypes
                getattr(lib, name).restype = ctypes.c_int
        libs.append(lib)
    return libs


# the sources phase 11 builds from another tree, where it has them
OTHER_SOURCES = ("correlation.cu", "farneback.cu", "horn_schunck.cu",
                 "scatter.cu", "pyramid.cu", "lfn_heads.cu",
                 "conv_epilogue.cu")
# C entries of other trees that this one no longer has: B8's first
# design, one level a call (src0, src1, images, dtype, dst0, dst1, H, W,
# OH, OW, vertical taps, horizontal taps, radius, ystart, yweights, ky,
# xstart, xweights, kx, tile_h, tile_w, seg, cols, shared bytes, stream);
# B14's first design, one reduce a call (src0, src1, images, dst0, dst1,
# H, W, taps, stream)
OTHER_SIGNATURES = {"transflow_pyramid_level": (
    ctypes.c_void_p, ctypes.c_void_p, *[ctypes.c_int] * 2,
    *[ctypes.c_void_p] * 2, *[ctypes.c_int] * 4, *[ctypes.c_void_p] * 2,
    ctypes.c_int, *[ctypes.c_void_p] * 2, ctypes.c_int,
    *[ctypes.c_void_p] * 2, *[ctypes.c_int] * 6, ctypes.c_void_p),
    "transflow_pyramid_reduce": (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, *[ctypes.c_void_p] * 2,
    *[ctypes.c_int] * 2, *[ctypes.c_void_p] * 2)}


def _entry(lib: ctypes.CDLL, name: str, *args):
    """A call of ``lib``'s raw C entry ``name`` on ``args``: no wrapper
    and no launch count."""
    fn = getattr(lib, name)

    def call():
        err = fn(*args)
        if err:
            raise RuntimeError(f"{name} failed: CUDA error {err}")
    return call


def corr_entry(lib: ctypes.CDLL, f1, f2, out, stride: int):
    """The correlation's raw C entry into the preallocated ``out``."""
    from transflow_tpu_torch._device import DTYPE_CODES, cuda_stream
    h, w, c = f1.shape
    return _entry(lib, "transflow_corr7x7", f1.data_ptr(),
                  DTYPE_CODES[f1.dtype], f2.data_ptr(),
                  DTYPE_CODES[f2.dtype], out.data_ptr(), h, w, c, stride, 0,
                  h, cuda_stream(f1))


def b1_entry(lib: ctypes.CDLL, images, outs):
    """B1 on both images of a level into ``outs`` (bf16 storage, poly_n
    ``FB_POLY_N``): one call of ``transflow_poly_expansion_pair`` where
    ``lib`` has it, else two of ``transflow_poly_expansion``."""
    from transflow_tpu_torch._device import DTYPE_CODES, cuda_stream
    from transflow_tpu_torch.ops.farneback import _poly_params
    params = _poly_params(FB_POLY_N, FB_POLY_SIGMA, BF16).ctypes.data_as(
        ctypes.c_void_p)
    h, w = images[0].shape
    code, stream = DTYPE_CODES[images[0].dtype], cuda_stream(images[0])
    if hasattr(lib, "transflow_poly_expansion_pair"):
        return _entry(lib, "transflow_poly_expansion_pair",
                      images[0].data_ptr(), images[1].data_ptr(), code,
                      outs[0].data_ptr(), outs[1].data_ptr(),
                      DTYPE_CODES[BF16], h, w, FB_POLY_N, params, stream)
    calls = [_entry(lib, "transflow_poly_expansion", image.data_ptr(), code,
                    out.data_ptr(), DTYPE_CODES[BF16], h, w, FB_POLY_N,
                    params, stream) for image, out in zip(images, outs)]
    return lambda: [call() for call in calls]


def b2a_entry(lib: ctypes.CDLL, polys, flow, out):
    """B2a (select radius 0) on both images' stacks into ``out``."""
    from transflow_tpu_torch._device import DTYPE_CODES, cuda_stream
    h, w = flow.shape[:2]
    return _entry(lib, "transflow_update_equations", polys[0].data_ptr(),
                  polys[1].data_ptr(), DTYPE_CODES[polys[0].dtype],
                  flow.data_ptr(), out.data_ptr(), h, w, 0, cuda_stream(flow))


def b2b_entry(lib: ctypes.CDLL, planes, flow, out):
    """B2b (the box of ``FB_WINSIZE``) on bf16 planes into ``out``."""
    from transflow_tpu_torch._device import DTYPE_CODES, cuda_stream
    from transflow_tpu_torch.ops.farneback import _window_params
    vtaps, htaps, symmetric = _window_params(FB_WINSIZE, False, BF16)
    h, w = flow.shape[:2]
    return _entry(lib, "transflow_aggregate_solve", planes.data_ptr(),
                  DTYPE_CODES[planes.dtype], flow.data_ptr(), out.data_ptr(),
                  h, w, len(vtaps), int(symmetric), 1,
                  vtaps.ctypes.data_as(ctypes.c_void_p),
                  htaps.ctypes.data_as(ctypes.c_void_p), cuda_stream(flow))


def hs_partials(lib: ctypes.CDLL, h: int, w: int) -> int:
    """The partial sums ``lib``'s B10 needs at (h, w): its own count, or
    one for each 8x32 tile in a tree whose B10 has no count entry (its
    first design)."""
    if hasattr(lib, "transflow_hs_iterate_partials"):
        return lib.transflow_hs_iterate_partials(h, w)
    return -(-h // 8) * -(-w // 32)


def hs_entries(lib: ctypes.CDLL, frames, planes, control, partials, flows):
    """B9 on the two frames into ``planes`` and ``control``, and B10's three
    launches under delta 1 from ``flows[0]`` into ``flows[1:]``, through
    ``lib``'s raw C entries."""
    from transflow_tpu_torch._device import cuda_stream
    from transflow_tpu_torch.ops.horn_schunck import _alpha2
    h, w = frames[0].shape
    stream = cuda_stream(planes)
    b9 = _entry(lib, "transflow_hs_derivatives", frames[0].data_ptr(),
                frames[1].data_ptr(), planes.data_ptr(), control.data_ptr(),
                h, w, _alpha2(1.0), stream)
    steps = [_entry(lib, "transflow_hs_iterate", planes.data_ptr(),
                    flows[k].data_ptr(), flows[k + 1].data_ptr(),
                    control.data_ptr(), partials.data_ptr(), partials.numel(),
                    h, w, 1.0, 1, stream) for k in range(3)]
    return b9, lambda: [step() for step in steps]


def in_turns(calls: dict) -> dict:
    """``device_ms`` of ``calls`` (this tree's first) in ``AGAINST_ROUNDS``
    rounds that run the others, this tree twice, then the others back
    (other, this, this, other for one): the medians and every round's
    times."""
    names = list(calls)
    times = {name: [] for name in names}
    for _ in range(AGAINST_ROUNDS):
        for name in (*names[::-1], *names):
            times[name].append(device_ms(calls[name]))
    torch.cuda.synchronize()
    return {"ms": {name: statistics.median(t) for name, t in times.items()},
            "times": times}


def _turns_text(turns: dict) -> str:
    medians = " ".join(f"{name} {ms:.5f}" for name, ms in turns["ms"].items())
    rounds = " ".join(f"{name} {[round(t, 5) for t in times]}"
                      for name, times in turns["times"].items())
    return f"device_ms {medians}; rounds {rounds}"


def _totals_text(total: dict) -> str:
    return " ".join(f"{name} {ms:.5f}" for name, ms in total.items())


def engine_b2a_inputs(run: dict) -> list[tuple]:
    """The (poly1, poly2, flow) of every B2a launch of the Engine of
    ``run`` (phase F's ``CvFlowConfig()``) over its next frame, copied as
    the estimator passes them to ``update_equations``."""
    from transflow_tpu_torch.flow.estimators import farneback as estimator
    engine, items, pixmaps = run["engine"], run["items"], run["pixmaps"]
    fno = run["next_fno"]
    run["next_fno"] = fno + 1
    update, inputs = estimator.update_equations, []

    def record(poly1, poly2, flow, radius):
        if radius:
            raise AssertionError("CvFlowConfig() runs B2a at radius 0")
        inputs.append((poly1.clone(), poly2.clone(), flow.clone()))
        return update(poly1, poly2, flow, radius)
    estimator.update_equations = record
    try:
        engine.process_frame([next(items)], pixmaps, fno / 30.0, ((fno,),))
    finally:
        estimator.update_equations = update
    torch.cuda.synchronize()
    if len(inputs) != FB_DEFAULT_PER_FRAME[1]:
        raise AssertionError(f"captured {len(inputs)} B2a launches of a "
                             f"frame, not {FB_DEFAULT_PER_FRAME[1]}")
    return inputs


def one_row_warps(flow) -> float:
    """Share of B2a's warps (32 pixels of a row) whose samples all take
    their taps from one pair of rows."""
    h, w = flow.shape[:2]
    ys = torch.arange(h, device=flow.device, dtype=torch.float32)[:, None]
    rows = torch.floor(ys + flow[..., 1]).clamp(0, h - 1)
    rows = torch.nn.functional.pad(rows[None], (0, -w % 32),
                                   mode="replicate")[0].view(h, -1, 32)
    return (rows.amax(-1) == rows.amin(-1)).float().mean().item()


def _check_outputs(label: str, outs: dict, exact: bool = True) -> None:
    """Each tree's outputs (``outs[name]``, a list of tensors) against this
    tree's: bit-equal, or within the correlation's tolerance."""
    for name, out in outs.items():
        for a, b in zip(outs["this"], out):
            same = torch.equal(a, b) if exact else torch.allclose(
                a, b, atol=CORR_ATOL, rtol=CORR_RTOL)
            if not same:
                raise AssertionError(f"against {label}: {name}'s outputs "
                                     "differ from this tree's")


def phase_against(device, libs: dict, card: str, fb_run: dict,
                  b5_flow) -> None:
    """This tree's correlation kernel, B1, B2a and B2b (``libs["this"]``)
    against the other trees' (``libs``, by name; ``build_others``), all
    through the raw C entries,
    ``device_ms`` in turns: the correlation at the five level shapes in
    the slice's dtype pairs (outputs within 1e-5); B1 on both images of a
    level, B2a at select radius 0 on a random flow and on the pan, and
    B2b's box at the four 1080p level shapes in bf16, as the main path
    gives them; then B2a on the inputs of each of its launches in one frame
    of the Farneback Engine (``fb_run``), with the share of its warps whose
    samples share their tap rows (``one_row_warps``); Farneback outputs
    bit-equal. Last, where a tree has ``horn_schunck.cu``, B9 and B10
    (``against_horn_schunck``), and where it has ``scatter.cu``, B5 on
    ``b5_inputs`` with ``b5_flow`` as the pan's (``against_scatter``)."""
    from transflow_tpu_torch.ops import farneback as fb
    gen = torch.Generator(device=device).manual_seed(SEED)
    total = dict.fromkeys([*libs, "bound"], 0.0)
    for h, w, c, stride, level in CORR_SHAPES:
        t1, t2 = MAIN_PAIR[level]
        f1 = torch.randn((h, w, c), generator=gen, device=device).to(t1)
        f2 = torch.randn((h, w, c), generator=gen, device=device).to(t2)
        outs = {name: [torch.empty((-(-h // stride), -(-w // stride), 49),
                                   device=device)] for name in libs}
        turns = in_turns({name: corr_entry(lib, f1, f2, outs[name][0], stride)
                          for name, lib in libs.items()})
        _check_outputs(f"corr {level}", outs, exact=False)
        diff = max((outs["this"][0] - out[0]).abs().max().item()
                   for out in outs.values())
        bound = corr_bound_ms(h, w, c, stride, t1, t2)[0]
        for name, value in (*turns["ms"].items(), ("bound", bound)):
            total[name] += value
        print(f"against corr {level} ({h},{w},{c}) s{stride} "
              f"{_pair(t1, t2)}: {_turns_text(turns)}; bound {bound:.5f}; "
              f"|diff| {diff:.3e}")
    print(f"against corr per frame: device_ms {_totals_text(total)} on "
          f"{card}")

    fb_total = {k: dict.fromkeys([*libs, "bound"], 0.0)
                for k in ("B1", "B2a random", "B2a smooth", "B2b")}
    for h, w, level in FB_LEVELS:
        images = [torch.rand((h, w), generator=gen, device=device) * 255
                  for _ in range(2)]
        if level == "L0":
            images = [img.to(BF16) for img in images]
        flow = warp_flow(h, w, 4, True, gen, device)
        polys = fb.poly_expansion_pair_cuda(*images, FB_POLY_N, FB_POLY_SIGMA,
                                            BF16)
        planes = fb.update_equations_cuda(*polys, flow, 0)
        b2a_flows = {"random": flow, "smooth": pan_flow(h, w, device)}
        cases = {
            "B1": ({name: [torch.empty((h, w, 5), dtype=BF16, device=device)
                           for _ in images] for name in libs},
                   lambda lib, out: b1_entry(lib, images, out),
                   fb_bound_ms("poly_expansion", h, w, BF16, images[0].dtype),
                   FB_PER_LEVEL["poly_expansion"], ""),
            **{f"B2a {kind}": (
                {name: [torch.empty((6, h, w), dtype=BF16, device=device)]
                 for name in libs},
                lambda lib, out, f=f: b2a_entry(lib, polys, f, out[0]),
                fb_bound_ms("update_equations", h, w, BF16),
                FB_PER_LEVEL["update_equations"],
                f"; one-row warps {one_row_warps(f):.1%}")
               for kind, f in b2a_flows.items()},
            "B2b": ({name: [torch.empty((h, w, 2), device=device)]
                     for name in libs},
                    lambda lib, out: b2b_entry(lib, planes, flow, out[0]),
                    fb_bound_ms("aggregate_solve", h, w, BF16),
                    FB_PER_LEVEL["aggregate_solve"], ""),
        }
        for kernel, (outs, entry, bound, per_level, note) in cases.items():
            turns = in_turns({name: entry(lib, outs[name])
                              for name, lib in libs.items()})
            _check_outputs(f"{kernel} {level}", outs)
            for name, value in (*turns["ms"].items(), ("bound", bound[0])):
                fb_total[kernel][name] += per_level * value
            print(f"against {kernel} {level} ({h},{w}) bf16: "
                  f"{_turns_text(turns)}; bound {bound[0]:.5f} "
                  f"({bound[1]}){note}; outputs bit-equal")
    for kernel, t in fb_total.items():
        print(f"against {kernel} per frame: device_ms {_totals_text(t)} on "
              f"{card}")

    levels = {(h, w): level for h, w, level in FB_LEVELS}
    engine_total = dict.fromkeys([*libs, "bound"], 0.0)
    for k, (poly1, poly2, flow) in enumerate(engine_b2a_inputs(fb_run)):
        h, w = flow.shape[:2]
        outs = {name: [torch.empty((6, h, w), dtype=poly1.dtype,
                                   device=device)] for name in libs}
        turns = in_turns({name: b2a_entry(lib, (poly1, poly2), flow,
                                          outs[name][0])
                          for name, lib in libs.items()})
        label = f"B2a engine {levels.get((h, w), (h, w))} launch {k}"
        _check_outputs(label, outs)
        bound = fb_bound_ms("update_equations", h, w, poly1.dtype)[0]
        for name, value in (*turns["ms"].items(), ("bound", bound)):
            engine_total[name] += value
        print(f"against {label} ({h},{w}) {str(poly1.dtype)[6:]}: "
              f"{_turns_text(turns)}; bound {bound:.5f}; one-row warps "
              f"{one_row_warps(flow):.1%}, max |flow| "
              f"{flow.abs().max().item():.3f}; outputs bit-equal")
    print(f"against B2a engine per frame: device_ms "
          f"{_totals_text(engine_total)} on {card}")
    against_horn_schunck(device, libs, card)
    against_scatter(device, libs, card, b5_flow)


def against_horn_schunck(device, libs: dict, card: str) -> None:
    """Phase 11's Horn-Schunck part: B9 on the pan's 1080p frames and
    B10's three launches under delta 1 from a zero flow, in every library
    of ``libs`` (name to ctypes library, this tree's as "this") that has
    them, ``device_ms`` in turns; planes, flows and control words
    bit-equal between the trees."""
    hs_libs = {name: lib for name, lib in libs.items()
               if hasattr(lib, "transflow_hs_iterate")}
    gray = gray_frames(2, HEIGHT, WIDTH, device)
    frames = (gray[1].contiguous(), gray[0].contiguous())
    # the pan never stops the three steps; partials for the tree that
    # needs the most
    count = max(hs_partials(lib, HEIGHT, WIDTH) for lib in hs_libs.values())
    bufs, calls = {}, {}
    for name, lib in hs_libs.items():
        bufs[name] = (torch.empty((4, HEIGHT, WIDTH), device=device),
                      torch.empty(4, dtype=torch.int32, device=device),
                      torch.empty(count, dtype=torch.float64, device=device),
                      [torch.zeros((HEIGHT, WIDTH, 2), device=device)]
                      + [torch.empty((HEIGHT, WIDTH, 2), device=device)
                         for _ in range(3)])
        calls[name] = hs_entries(lib, frames, *bufs[name])
        for call in calls[name]:
            call()
    torch.cuda.synchronize()
    _check_outputs("B9 and B10", {
        name: [planes, *flows[1:], control[:2].clone()]
        for name, (planes, control, _, flows) in bufs.items()})
    steps = bufs["this"][1][:2].tolist()
    for k, kernel in enumerate(("hs_derivatives", "hs_iterate")):
        turns = in_turns({name: pair[k] for name, pair in calls.items()})
        bound = (1 + 2 * k) * hs_bound_ms(kernel, HEIGHT, WIDTH)[0]
        label = "B9" if k == 0 else "B10 x3 (delta 1)"
        print(f"against {label} ({HEIGHT},{WIDTH}) per frame: "
              f"{_turns_text(turns)}; bound {bound:.5f}; outputs bit-equal "
              f"(control {steps}, {count} partials) on {card}")
    if any(int(control[0]) for _, control, _, _ in bufs.values()):
        raise AssertionError("against B10: the stop word was set on the "
                             "pan, so the timed launches copied through")


def against_scatter(device, libs: dict, card: str, b5_flow) -> None:
    """Phase 11's B5 part: ``transflow_forward_to_backward`` of every
    library of ``libs`` (name to ctypes library, this tree's as "this")
    that has it, on each of ``b5_inputs`` (``b5_flow`` as the pan's),
    ``device_ms`` in turns and each device event's time by name
    (``torch.profiler``); outputs bit-equal between the trees and to the
    plain version. Each tree takes its own ``winner`` of H*W + 2 words,
    zeroed once, as this tree's wrapper keeps one (a tree that clears its
    scratch in every call clears it anyway)."""
    from transflow_tpu_torch._device import cuda_stream
    from transflow_tpu_torch.ops.scatter import forward_to_backward_plain
    b5_libs = {name: lib for name, lib in libs.items()
               if hasattr(lib, "transflow_forward_to_backward")}
    stream = cuda_stream(b5_flow)
    winners = {name: torch.zeros(HEIGHT * WIDTH + 2, dtype=torch.int32,
                                 device=device) for name in b5_libs}
    bound, by = b5_bound_ms(HEIGHT, WIDTH)
    for kind, flow in b5_inputs(device, b5_flow).items():
        outs = {name: [torch.empty_like(flow)] for name in b5_libs}
        calls = {name: _entry(lib, "transflow_forward_to_backward",
                              flow.data_ptr(), winners[name].data_ptr(),
                              outs[name][0].data_ptr(), HEIGHT, WIDTH,
                              stream) for name, lib in b5_libs.items()}
        for call in calls.values():
            call()
        torch.cuda.synchronize()
        _check_outputs(f"B5 {kind}", outs)
        if not torch.equal(outs["this"][0], forward_to_backward_plain(flow)):
            raise AssertionError(f"against B5 {kind}: this tree's output "
                                 "differs from the plain version")
        turns = in_turns(calls)
        splits = {name: kernel_split(call) for name, call in calls.items()}
        print(f"against B5 {kind} ({HEIGHT},{WIDTH}): {_turns_text(turns)}; "
              "kernel_ms (every device event) "
              + " ".join(f"{name} {sum(split.values()):.5f} ("
                         + ", ".join(f"{_short_name(event)} {ms:.5f}"
                                     for event, ms in sorted(split.items()))
                         + ")" for name, split in splits.items())
              + f"; bound {bound:.5f} ({by}); outputs bit-equal on {card}")


def level_entry_plan(h: int, w: int, lh: int, lw: int, radius: int,
                     images: int) -> tuple[int, int, int, int, int]:
    """The tile of B8's first design, the one-level entry
    ``transflow_pyramid_level``, which checks it (that tree's
    ``ops/pyramid.py::level_plan``): (tile rows, tile
    columns, the most segment columns and the most blurred columns a tile
    reads, shared bytes)."""
    from transflow_tpu_torch.ops import pyramid
    wy = pyramid.resize_weights(h, lh)[1]
    xs, wx = pyramid.resize_weights(w, lw)
    tile_w = next((tw for tw in range(min(lw, 128), 1, -1)
                   if pyramid._span(xs, wx.shape[1], tw) + 2 * radius <= 256),
                  1)
    tile_h = 8
    while tile_h > 1 and (-(-lw // tile_w) * -(-lh // tile_h) * images
                          < 2 * pyramid.SMS):
        tile_h //= 2
    cols = pyramid._span(xs, wx.shape[1], tile_w)
    seg = cols + 2 * radius
    nbytes = 4 * (tile_h * (seg + cols) + 2 * (2 * radius + 1)
                  + tile_h * (wy.shape[1] + 1) + tile_w * (wx.shape[1] + 1))
    return tile_h, tile_w, seg, cols, nbytes


def b8_entry(lib: ctypes.CDLL, images, levels):
    """(call, outputs) of B8 through ``lib``'s raw C entries on ``images``
    at ``levels`` ((sigma, lh, lw), ...): ``transflow_pyramid_levels``'s
    launches where ``lib`` has it, else a ``transflow_pyramid_level`` call
    a level (B8's first design); the outputs a tuple a level, as
    ``pyramid_levels`` returns them."""
    from transflow_tpu_torch._device import DTYPE_CODES, cuda_stream
    from transflow_tpu_torch.ops import pyramid
    image = images[0]
    code, stream, n = DTYPE_CODES[image.dtype], cuda_stream(image), len(images)
    if hasattr(lib, "transflow_pyramid_levels"):
        outs, scratch, launches = pyramid.level_tables(images, levels)
        calls = [_entry(lib, "transflow_pyramid_levels", table.ctypes.data,
                        count, n, code, nbytes, stream)
                 for table, count, nbytes in launches]
    else:
        h, w = image.shape
        outs, calls, scratch, launches = [], [], None, None
        pad = [0] * (2 - n)
        for sigma, lh, lw in levels:
            radius = pyramid.blur_radius(sigma)
            vtaps, htaps = pyramid._taps_on(sigma, image.dtype, image.device)
            ystart, yweights = pyramid._bands_on(h, lh, image.device)
            xstart, xweights = pyramid._bands_on(w, lw, image.device)
            level = tuple(torch.empty((lh, lw), device=image.device)
                          for _ in images)
            outs.append(level)
            calls.append(_entry(
                lib, "transflow_pyramid_level",
                *[t.data_ptr() for t in images], *pad, n, code,
                *[t.data_ptr() for t in level], *pad, h, w, lh, lw,
                vtaps.data_ptr(), htaps.data_ptr(), radius,
                ystart.data_ptr(), yweights.data_ptr(), yweights.shape[1],
                xstart.data_ptr(), xweights.data_ptr(), xweights.shape[1],
                *level_entry_plan(h, w, lh, lw, radius, n), stream))

    def call():
        for c in calls:
            c()
    # the launches' tables and the deep levels' scratch, which the raw
    # calls point into, live as long as the call
    call.keep = (scratch, launches)
    return call, outs


# phase 11's B8 cases (name, levels): the main path's pyramid, then its
# levels alone and fb_levels 8's deepest
B8_AGAINST = (("pyramid", B8_LEVELS),
              *((name, ((h, w, name, sigma),))
                for h, w, name, sigma in B8_LEVELS + B8_OFF_PATH[1:]))


def against_pyramid(device, libs: dict, steps: dict, card: str) -> None:
    """B8 of this tree (``libs["this"]``) against the other trees'
    (``libs``) and the ``steps`` copies (a tree's pyramid.cu cut to some
    of its steps, whose outputs are not held to this tree's), through the
    raw C entries (``b8_entry``), ``device_ms`` in turns, on both bf16
    images of a 1080p frame at ``B8_AGAINST``: the other trees' outputs
    bit-equal to this tree's."""
    from transflow_tpu_torch.ops import pyramid
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    images = [torch.randint(0, 256, (HEIGHT, WIDTH), generator=gen,
                            device=device).to(BF16) for _ in range(2)]
    def has_b8(lib):
        return hasattr(lib, "transflow_pyramid_levels") or hasattr(
            lib, "transflow_pyramid_level")
    libs = {name: lib for name, lib in libs.items() if has_b8(lib)}
    steps = {name: lib for name, lib in steps.items() if has_b8(lib)}
    if len(libs) + len(steps) < 2:
        return
    for case, cases in B8_AGAINST:
        levels = [(sigma, h, w) for h, w, _, sigma in cases]
        entries = {name: b8_entry(lib, images, levels)
                   for name, lib in (libs | steps).items()}
        turns = in_turns({name: call for name, (call, _) in entries.items()})
        _check_outputs(f"B8 {case}", {
            name: [t for level in entries[name][1] for t in level]
            for name in libs})
        bound = pyramid_bound_ms("pyramid_levels", HEIGHT, WIDTH,
                                 [(h, w, sigma) for sigma, h, w in levels],
                                 BF16)
        print(f"against B8 {case} ({len(levels)} level(s), both images) "
              f"bf16: {_turns_text(turns)}; bound {bound[0]:.5f} "
              f"({bound[1]}); {', '.join(libs)} bit-equal"
              + (f"; {', '.join(steps)} not held to them" if steps else "")
              + f" on {card}")


# phase 11's B14 cases: lukas-kanade.json's pyramid of the uint8 pair,
# then each reduce alone (both images a call)
B14_AGAINST = ("pyramid", "L1", "L2")


def b14_entry(lib: ctypes.CDLL, case: str, frames, pyr):
    """(call, outputs) of B14 through ``lib``'s raw C entries on the pan's
    uint8 ``frames``: case "pyramid" makes every level of ``pyr`` (this
    tree's, a (prev, next) tuple a level) in one ``transflow_lk_pyramid``
    launch, or in an older tree ATen's casts of the frames and one
    ``transflow_pyramid_reduce`` call a level; "L1" or "L2" one reduce of
    both images of the level above (from ``pyr``), one call."""
    from transflow_tpu_torch._device import cuda_stream
    from transflow_tpu_torch.ops import pyramid
    stream = cuda_stream(frames[0])
    new = hasattr(lib, "transflow_lk_pyramid")
    taps = torch.tensor(pyramid.REDUCE_TAPS, device=frames[0].device)

    def ptrs(images):
        return [t.data_ptr() for t in images]

    def reduce(src, dst):
        h, w = src[0].shape
        if new:
            table = pyramid._lk_table([(), dst])
            call = _entry(lib, "transflow_lk_pyramid", *ptrs(src), 2,
                          pyramid.LK_CODES[F32], table.ctypes.data, h, w, 1,
                          stream)
            call.keep = table
            return call
        return _entry(lib, "transflow_pyramid_reduce", *ptrs(src), 2,
                      *ptrs(dst), h, w, taps.data_ptr(), stream)

    if case != "pyramid":
        k = B14_AGAINST.index(case)
        outs = [tuple(torch.empty_like(t) for t in pyr[k])]
        call = reduce(pyr[k - 1], outs[0])
        call.keep = (getattr(call, "keep", None), taps)
        return call, outs
    outs = [tuple(torch.empty_like(t) for t in level) for level in pyr]
    if new:
        table = pyramid._lk_table(outs)
        call = _entry(lib, "transflow_lk_pyramid", *ptrs(frames), 2,
                      pyramid.LK_CODES[U8], table.ctypes.data,
                      *frames[0].shape, len(outs) - 1, stream)
        call.keep = table
        return call, outs
    reduces = [reduce(outs[k], outs[k + 1]) for k in range(len(outs) - 1)]

    def call():
        for out, frame in zip(outs[0], frames):
            out.copy_(frame)
        for r in reduces:
            r()
    call.keep = taps
    return call, outs


def against_lk_pyramid(device, libs: dict, steps: dict, card: str) -> None:
    """B14 of this tree (``libs["this"]``) against the other trees'
    (``libs``) and the ``steps`` copies (a tree's pyramid.cu cut to some
    of its steps, whose outputs are not held to the others'), through the
    raw C entries (``b14_entry``), ``device_ms`` in turns, at
    ``B14_AGAINST`` on the pan's 1080p uint8 pair, then each entry's
    profiler time of a call: the other trees' outputs bit-equal to this
    tree's."""
    from transflow_tpu_torch.ops import pyramid

    def has_b14(lib):
        return hasattr(lib, "transflow_lk_pyramid") or hasattr(
            lib, "transflow_pyramid_reduce")
    libs = {name: lib for name, lib in libs.items() if has_b14(lib)}
    steps = {name: lib for name, lib in steps.items() if has_b14(lib)}
    if len(libs) + len(steps) < 2:
        return
    gray = gray_frames(2, HEIGHT, WIDTH, device)
    frames = (gray[1].contiguous(), gray[0].contiguous())
    pyr = pyramid.lk_pyramid_plain(*frames, H_LK_WIN, H_LK_MAX_LEVEL)
    for case in B14_AGAINST:
        entries = {name: b14_entry(lib, case, frames, pyr)
                   for name, lib in (libs | steps).items()}
        turns = in_turns({name: call for name, (call, _) in entries.items()})
        _check_outputs(f"B14 {case}", {
            name: [t for level in entries[name][1] for t in level]
            for name in libs})
        k = B14_AGAINST.index(case)
        bound = (pyramid_bound_ms(
            "lk_pyramid", HEIGHT, WIDTH,
            [(lh, lw, 0.0) for lh, lw, _ in H_LK_LEVELS[1:]], U8)
            if case == "pyramid" else pyramid_bound_ms(
                "downsample2x", *H_LK_LEVELS[k - 1][:2],
                (H_LK_LEVELS[k][:2] + (0.0,),), F32))
        print(f"against B14 {case} (both images): {_turns_text(turns)}; "
              f"bound {bound[0]:.5f} ({bound[1]}); {', '.join(libs)} "
              "bit-equal"
              + (f"; {', '.join(steps)} not held to them" if steps else "")
              + f" on {card}")
        # device_ms of a call that takes under ~8 us reads the host's rate
        # of ctypes calls: the profiler's time of each device event
        for name, (call, _) in entries.items():
            split = kernel_split(call)
            print(f"kernel time B14 {case} {name}: "
                  f"{sum(split.values()):.5f} ms a call ("
                  + ", ".join(f"{_short_name(k)} {ms:.5f}"
                              for k, ms in split.items())
                  + f"; torch.profiler) on {card}")


def up_entry(lib: ctypes.CDLL, x, weight, out):
    """B16 through ``lib``'s raw C entry into the preallocated ``out``."""
    from transflow_tpu_torch._device import DTYPE_CODES, cuda_stream
    h, w, c = x.shape
    return _entry(lib, "transflow_upsample2x_phases", x.data_ptr(),
                  DTYPE_CODES[x.dtype], weight.data_ptr(), out.data_ptr(), h,
                  w, c, cuda_stream(x))


def reg_entry(lib: ctypes.CDLL, dist, flow, params, out):
    """B17 through ``lib``'s raw C entry into the preallocated ``out``;
    ``params`` are (wx, bx, wy, by)."""
    from transflow_tpu_torch._device import DTYPE_CODES, cuda_stream
    h, w = flow.shape[:2]
    size = int(round(dist.shape[-1] ** 0.5))
    return _entry(lib, "transflow_reg_apply", dist.data_ptr(),
                  DTYPE_CODES[dist.dtype], flow.data_ptr(),
                  DTYPE_CODES[flow.dtype], *[p.data_ptr() for p in params],
                  out.data_ptr(), h, w, size, cuda_stream(dist))


def against_lfn_heads(device, libs: dict, steps: dict, card: str) -> None:
    """Phase 11's LiteFlowNet heads: B16 at ``B16_SHAPES`` in float32 (the
    path's) and B17 at ``B17_LEVELS`` with bf16 distances and the flow in
    the path's dtype (bf16 at L6), in every library of ``libs`` (name to
    ctypes library, this tree's as "this") and of ``steps`` (copies of a
    tree's lfn_heads.cu cut to some of its steps, whose outputs are not
    held to the others') that has them, through the raw C entries:
    ``device_ms`` in turns and each library's profiler kernel time of a
    call; the trees' outputs bit-equal; then both kernels' sums over a
    frame's launches (one a shape)."""
    def has_heads(lib):
        return hasattr(lib, "transflow_upsample2x_phases")
    held = [name for name, lib in libs.items() if has_heads(lib)]
    heads = {name: lib for name, lib in (libs | steps).items()
             if has_heads(lib)}
    if len(heads) < 2:
        return
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    cases = []
    for h, w, c, name in B16_SHAPES:
        x = torch.randn((h, w, c), generator=gen, device=device)
        weight = 0.5 * torch.randn((c, 1, 4, 4), generator=gen,
                                   device=device)
        outs = {n: [torch.empty((2 * h, 2 * w, c), device=device)]
                for n in heads}
        cases.append(("B16", f"{name} ({h},{w},{c}) f32", (x, weight), outs,
                      {n: up_entry(lib, x, weight, outs[n][0])
                       for n, lib in heads.items()},
                      up_bound_ms(h, w, c, F32), "upsample2x_phases_kernel"))
    for h, w, size, name in B17_LEVELS:
        taps = size * size
        flow_dtype = BF16 if name == "L6" else F32
        dist = (1.5 * torch.randn((h, w, taps), generator=gen,
                                  device=device)).to(BF16)
        reach = B7_REACH * w / B7_LEVELS[-1][1]
        flow = (reach * (2 * torch.rand((h, w, 2), generator=gen,
                                        device=device) - 1)).to(flow_dtype)
        params = [torch.randn(shape, generator=gen, device=device)
                  for shape in ((1, taps, 1, 1), (1,), (1, taps, 1, 1),
                                (1,))]
        outs = {n: [torch.empty((h, w, 2), device=device)] for n in heads}
        cases.append(("B17", f"{name} ({h},{w},{taps}) dist bf16 flow "
                      f"{str(flow_dtype)[6:]}", (dist, flow, params), outs,
                      {n: reg_entry(lib, dist, flow, params, outs[n][0])
                       for n, lib in heads.items()},
                      reg_bound_ms(h, w, size, BF16, flow_dtype),
                      "reg_apply_kernel"))
    total = {k: {key: dict.fromkeys([*heads, "bound"], 0.0)
                 for key in ("device_ms", "kernel_ms")}
             for k in ("B16", "B17")}
    # the raw calls hold pointers: each case keeps its inputs alive
    for kernel, label, _, outs, calls, bound, pattern in cases:
        for call in calls.values():
            call()
        torch.cuda.synchronize()
        _check_outputs(f"{kernel} {label}", {n: outs[n] for n in held})
        turns = in_turns(calls)
        times = {n: kernel_ms(call, pattern) for n, call in calls.items()}
        for n in heads:
            total[kernel]["device_ms"][n] += turns["ms"][n]
            total[kernel]["kernel_ms"][n] += times[n] or float("nan")
        for key in ("device_ms", "kernel_ms"):
            total[kernel][key]["bound"] += bound[0]
        cut = [n for n in heads if n not in held]
        print(f"against {kernel} {label}: {_turns_text(turns)}; kernel_ms "
              + " ".join(f"{n} {_ms_text(t)}" for n, t in times.items())
              + f"; bound {bound[0]:.5f} ({bound[1]}); {', '.join(held)} "
              "bit-equal"
              + (f"; {', '.join(cut)} not held to them" if cut else "")
              + f" on {card}")
    for kernel, t in total.items():
        print(f"against {kernel} per frame: device_ms "
              f"{_totals_text(t['device_ms'])}; kernel_ms "
              f"{_totals_text(t['kernel_ms'])} on {card}")


def b18_entry(lib: ctypes.CDLL, y, bias, out, leaky: bool):
    """B18 through ``lib``'s raw C entry from the (N, C, H, W) ``y`` into
    the preallocated (N, H, W, C) ``out``."""
    from transflow_tpu_torch._device import DTYPE_CODES, cuda_stream
    n, c, h, w = y.shape
    return _entry(lib, "transflow_conv_epilogue", y.data_ptr(),
                  DTYPE_CODES[y.dtype], bias.data_ptr(), out.data_ptr(), n,
                  h * w, c, int(not y.permute(0, 2, 3, 1).is_contiguous()),
                  int(leaky), cuda_stream(y))


def against_conv_epilogue(device, libs: dict, card: str) -> None:
    """Phase 11's B18, where another tree of ``libs`` (name to ctypes
    library, this tree's as "this") has it: every ``B18_FRAME`` entry in
    bf16 from a channels_last input into each tree's own output, through
    the raw C entries: ``device_ms`` in turns and each tree's profiler
    kernel time of a call, the trees' outputs bit-equal; then their sums
    over a frame's 93 launches."""
    from transflow_tpu_torch.ops import conv_epilogue as ce
    trees = {name: lib for name, lib in libs.items()
             if hasattr(lib, "transflow_conv_epilogue")}
    if len(trees) < 2:
        return
    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    total = {key: dict.fromkeys([*trees, "bound"], 0.0)
             for key in ("device_ms", "kernel_ms")}
    for shape, leaky, count, name in B18_FRAME:
        y, bias = b18_input(shape, BF16, ce.CHANNELS_LAST, gen, device)
        outs = {n: [torch.empty(shape, dtype=BF16, device=device)]
                for n in trees}
        calls = {n: b18_entry(lib, y, bias, outs[n][0], leaky)
                 for n, lib in trees.items()}
        for call in calls.values():
            call()
        torch.cuda.synchronize()
        _check_outputs(f"B18 {name}", outs)
        turns = in_turns(calls)
        times = {n: kernel_ms(call, "conv_epilogue")
                 for n, call in calls.items()}
        bound = epilogue_bound_ms(shape, BF16, leaky)
        for n in trees:
            total["device_ms"][n] += count * turns["ms"][n]
            total["kernel_ms"][n] += count * (times[n] or float("nan"))
        for key in total:
            total[key]["bound"] += count * bound[0]
        print(f"against B18 {name} {shape} x{count}: {_turns_text(turns)}; "
              "kernel_ms "
              + " ".join(f"{n} {_ms_text(t)}" for n, t in times.items())
              + f"; bound {bound[0]:.5f} ({bound[1]}); bit-equal on {card}")
    print(f"against B18 per frame: device_ms "
          f"{_totals_text(total['device_ms'])}; kernel_ms "
          f"{_totals_text(total['kernel_ms'])} on {card}")


def _short_name(event: str) -> str:
    """A device event's name short of its namespaces, template arguments
    and parameters."""
    name = event.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0].split("<")[0].split("::")[-1].strip() or event


def _bound_by(rows) -> str:
    """What bounds the largest of the rows' bounds."""
    return max(rows, key=lambda r: r["bound_ms"])["bound_by"]


def _per_frame(rows, key: str, weight=None) -> float | None:
    """Sum of ``key`` over rows (one frame's launches), each times its
    launches per frame; None where a row lacks it."""
    values = [r[key] for r in rows]
    if any(v is None for v in values):
        return None
    weights = [1] * len(rows) if weight is None else weight
    return sum(n * v for n, v in zip(weights, values))


def against_arg(text: str) -> tuple[str, Path]:
    """``--against``'s value ``[NAME=]CSRC_DIR`` as (name, directory); the
    name defaults to the directory."""
    name, sep, path = text.partition("=")
    return (name, Path(path)) if sep else (text, Path(text))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", type=against_arg, action="append",
                        default=[], metavar="[NAME=]CSRC_DIR",
                        help="also time the correlation kernel, B1, B2a, "
                             "B2b, B9, B10, B5, B8, B14, B16 and B17 "
                             "against this directory's correlation.cu, "
                             "farneback.cu, horn_schunck.cu, scatter.cu, "
                             "pyramid.cu and lfn_heads.cu (phase 11); "
                             "repeat it for several trees")
    parser.add_argument("--steps", type=against_arg, action="append",
                        default=[], metavar="[NAME=]CSRC_DIR",
                        help="also time B8 and B14 of this directory's "
                             "pyramid.cu, or B16 and B17 of its "
                             "lfn_heads.cu, a copy of a tree's cut to some "
                             "of its steps, in phase 11's turns, its "
                             "outputs not held to this tree's; repeat it "
                             "for several copies")
    parser.add_argument("--lfn-profile", action="store_true",
                        help="only phase 4's bound-0 LiteFlowNet Engine: its "
                             "host syncs, ATen ops and profile a frame, "
                             "with the package beside this script")
    parser.add_argument("--multihost-worker", type=int, nargs=2,
                        metavar=("RANK", "PORT"), help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.multihost_worker:  # one of phase M's processes
        return multihost_worker(*args.multihost_worker)
    if args.lfn_profile:
        lfn_profile_only(torch.device("cuda", 0), phase_device())
        return 0
    card = phase_device()
    libav = phase_libav()
    device = torch.device("cuda", 0)
    reports = phase_build()
    fb_runs = phase_farneback_engine(device, card)
    phase_pipeline(device, card)
    t_run = phase_postprocess(device, card)
    h_runs = phase_classic_engine(device, card)
    if libav:
        phase_video(device, card)
    s_run = phase_streams(device, card)
    m_run = phase_multihost(device, card)
    phase_live(device, card)
    phase_bench(device, card)
    slice_launches = phase_slice(device, card)
    engine_phase = phase_engine(device, card)
    mesh_run = phase_mesh_engine(device, card, engine_phase)
    rows = phase_kernels(device)
    warp_rows = phase_warp_kernels(device)
    b7_rows = phase_exact_warp_kernels(device)
    up_rows, reg_rows = phase_lfn_head_kernels(device)
    b18_rows = phase_conv_epilogue_kernels(device)
    a2_rows = phase_sharded_kernels(device)
    fb_rows = phase_farneback_kernels(device)
    b5_rows = phase_scatter_kernel(device, t_run["b5_flow"])
    h_rows = phase_classic_kernels(device)
    phase_equivalence(device)
    phase_draw(device)
    c_rows = phase_compositor_kernels(device, fb_runs["CvFlowConfig()"],
                                      t_run)
    phase_kernel_time(rows, a2_rows, warp_rows, b7_rows, up_rows, reg_rows,
                      b18_rows, fb_rows, b5_rows, h_rows, c_rows)
    f_profile = engine_profile("farneback engine CvFlowConfig()",
                               fb_runs["CvFlowConfig()"], FB_PROFILE_CALLS,
                               card)
    found = sorted(op for op in F_REPLACED_OPS if op in f_profile["aten_ops"])
    found += sorted(n for n in f_profile["device_names"]
                    if "cudnn" in n.lower())
    if found:
        raise AssertionError(f"phase F's profile shows the replaced "
                             f"pyramid path: {found}")
    print(f"profile farneback engine CvFlowConfig(): none of "
          f"{', '.join(F_REPLACED_OPS)} and no cuDNN kernel; "
          f"{f_profile['events']:.1f} device events and "
          f"{f_profile['busy_ms']:.3f} ms busy a frame, "
          f"{fb_runs['CvFlowConfig()']['syncs']:g} host syncs a frame")
    # B8 in the profile (which may miss a few of the window's events):
    # the pyramid's launches and their kernel time
    b8 = [v for k, v in f_profile["by_name"].items()
          if "pyramid_levels_kernel" in k]
    if f_profile["by_name"]:
        b8_events = sum(n for _, n in b8)
        if not 0 < b8_events <= FB_DEFAULT_PER_FRAME[3]:
            raise AssertionError(f"phase F's profile shows {b8_events} B8 "
                                 f"launches a frame, not "
                                 f"{FB_DEFAULT_PER_FRAME[3]}")
        print(f"profile farneback engine CvFlowConfig(): B8 "
              f"{sum(ms for ms, _ in b8) / b8_events:.5f} ms of kernel "
              f"time a launch, {b8_events:g} launches a frame seen of "
              f"{FB_DEFAULT_PER_FRAME[3]} (torch.profiler) on {card}")
    lfn = lfn_profile("liteflownet engine lfn_warp_bound=0",
                      engine_phase["runs"][0], card)
    # the correlation's five float32 leaky ReLUs stay plain ops
    if lfn["audit"] != {"bias adds": 0, "parameter casts": 0,
                        "leaky_relu float32": 5}:
        raise AssertionError(f"the bound-0 Engine still runs ops B18 "
                             f"replaced: {lfn['audit']}")
    b18_events = sum(n for k, (_, n) in lfn["by_name"].items()
                     if LFN_KERNEL_NAMES["B18"] in k)
    if lfn["by_name"] and not 0 < b18_events <= B18_PER_FRAME:
        raise AssertionError(f"the bound-0 Engine's profile shows "
                             f"{b18_events} B18 launches a frame")
    for name, run in h_runs.items():
        run["profile"] = engine_profile(f"classic engine {name}", run,
                                        H_PROFILE_CALLS, card)
    profile = engine_profile("streams 2 x 1 horn-schunck, a frame of both "
                             "streams", s_run["step_run"], S_PROFILE_CALLS,
                             card, "one-frame sharded_scan calls")
    if "idle" in profile:
        print(f"streams per stream-frame: {profile['busy_ms'] / 2:.3f} ms "
              f"busy of {profile['wall_ms'] / 2:.3f} ms host clock, idle "
              f"{profile['idle']:.1%} on {card}")
    if args.against or args.steps:
        from transflow_tpu_torch._device import kernel_library
        libs = {"this": kernel_library()._lib}
        libs.update(zip((name for name, _ in args.against),
                        build_others([d for _, d in args.against], reports)))
        steps = dict(zip((name for name, _ in args.steps),
                         build_others([d for _, d in args.steps], reports)))
        if args.against:
            phase_against(device, libs, card, fb_runs["CvFlowConfig()"],
                          t_run["b5_flow"])
        against_pyramid(device, libs, steps, card)
        against_lk_pyramid(device, libs, steps, card)
        against_lfn_heads(device, libs, steps, card)
        against_conv_epilogue(device, libs, card)
    # one frame of the slice: the five levels in its dtype pairs
    main_rows = [r for r in rows if r["pair"] == MAIN_PAIR[r["level"]]]
    # one frame's launches: bf16 features, flows within the bound
    main_warp = [r for r in warp_rows
                 if r["dtype"] == BF16 and not r["beyond"]]
    warp_n = [WARP_PER_FRAME[r["level"]] for r in main_warp]
    # one frame of the mesh Engine: levels 2-5 over four shards
    mesh_a2 = [r for r in a2_rows if r["shards"] == MESH_SHARDS]
    a1_same = sum(r["a1_device_ms"] for r in mesh_a2)
    print(f"a2 per frame at {MESH_SHARDS} shards (levels "
          f"{', '.join(r['level'] for r in mesh_a2)}): device_ms A2 "
          f"{_per_frame(mesh_a2, 'device_ms'):.5f} (from views "
          f"{_per_frame(mesh_a2, 'views_device_ms'):.5f}), A1 on the same "
          "levels "
          f"{a1_same:.5f}, bound {_per_frame(mesh_a2, 'bound_ms'):.5f}, "
          f"plain {_per_frame(mesh_a2, 'plain_ms'):.4f}")
    # one frame of the Farneback Engine (CvFlowConfig()): bf16 storage,
    # the gather warp (on the random flow), the box window, FB_PER_LEVEL
    # launches per level
    fb_main = {name: [r for r in fb_rows if r["kernel"] == name
                      and r["storage"] == BF16 and "kernel_ms" in r
                      and r["flow"] == "random"]
               for name in FB_PER_LEVEL}
    groups = [("correlation7x7", main_rows, None),
              ("bounded_backwarp", main_warp, warp_n)]
    groups += [(name, group, [FB_PER_LEVEL[name]] * len(group))
               for name, group in fb_main.items()]
    smooth = [r for r in fb_rows if r["kernel"] == "update_equations"
              and r["storage"] == BF16 and "kernel_ms" in r
              and r["flow"] == "smooth"]
    groups.append(("update_equations on the pan", smooth,
                   [FB_PER_LEVEL["update_equations"]] * len(smooth)))
    for name, group, weight in groups:
        print(f"{name} per frame: device_ms "
              f"{_per_frame(group, 'device_ms', weight):.5f}, kernel_ms "
              f"{_ms_text(_per_frame(group, 'kernel_ms', weight))}, bound "
              f"{_per_frame(group, 'bound_ms', weight):.5f}, call "
              f"{_per_frame(group, 'call_ms', weight):.4f} (host-inclusive), "
              f"plain {_per_frame(group, 'plain_ms', weight):.4f}")
    no_library = "none: no single PyTorch call computes the cost volume"
    runs = engine_phase["runs"]
    record = {"kernels": [{
        "name": "correlation7x7",
        "route": "cuda",
        "source": "transflow_tpu_torch/csrc/correlation.cu",
        "replaces": "transflow_tpu/ops/pallas_correlation.py:110",
        # the slice's and the three Engine runs'
        "launches": slice_launches["A1"] + sum(
            run["launches"][1] for run in (*runs.values(), mesh_run)),
        "max_abs_err": max(r["err"] for r in rows),
        # per frame: the five levels in the slice's dtype pairs
        "ms": _per_frame(main_rows, "device_ms"),
        "device_ms": _per_frame(main_rows, "device_ms"),
        "kernel_ms": _per_frame(main_rows, "kernel_ms"),
        "call_ms": _per_frame(main_rows, "call_ms"),
        "plain_ms": _per_frame(main_rows, "plain_ms"),
        "bound_ms": _per_frame(main_rows, "bound_ms"),
        "bound_by": _bound_by(main_rows),
        "library_ms": None,
        "library": no_library,
    }, {
        "name": "bounded_backwarp",
        "route": "cuda",
        "source": "transflow_tpu_torch/csrc/bounded_warp.cu",
        "replaces": "transflow_tpu/ops/pallas_warp.py:117",
        "launches": runs[WARP_BOUND]["launches"][0],
        "max_abs_err": max(r["err"] for r in warp_rows),
        # per frame: nine launches over the five levels
        "ms": _per_frame(main_warp, "device_ms", warp_n),
        "device_ms": _per_frame(main_warp, "device_ms", warp_n),
        "kernel_ms": _per_frame(main_warp, "kernel_ms", warp_n),
        "library_kernel_ms": _per_frame(main_warp, "library_kernel_ms",
                                        warp_n),
        "call_ms": _per_frame(main_warp, "call_ms", warp_n),
        "plain_ms": _per_frame(main_warp, "plain_ms", warp_n),
        "bound_ms": _per_frame(main_warp, "bound_ms", warp_n),
        "bound_by": _bound_by(main_warp),
        "library_ms": _per_frame(main_warp, "library_ms", warp_n),
        "library": "torch.nn.functional.grid_sample (bilinear, zeros, "
                   "align_corners=True) on an f32 NCHW view",
    }, {
        "name": "sharded_correlation7x7",
        "route": "cuda",
        "source": "transflow_tpu_torch/csrc/correlation.cu",
        "replaces": "transflow_tpu/ops/pallas_correlation.py:138",
        # the mesh Engine's run
        "launches": mesh_run["launches"][2],
        "max_abs_err": max(r["err"] for r in a2_rows),
        # per frame: one call per level at levels 2-5
        "ms": _per_frame(mesh_a2, "device_ms"),
        "device_ms": _per_frame(mesh_a2, "device_ms"),
        "kernel_ms": _per_frame(mesh_a2, "kernel_ms"),
        "call_ms": _per_frame(mesh_a2, "call_ms"),
        "plain_ms": _per_frame(mesh_a2, "plain_ms"),
        "bound_ms": _per_frame(mesh_a2, "bound_ms"),
        "bound_by": _bound_by(mesh_a2),
        "library_ms": None,
        "library": no_library,
    }]}
    # B7 per frame at bound 0: the 9 bf16 feature warps and the 5 image
    # warps; its launches: the slice's and the bound-0, bound-16 and mesh
    # Engines' (phases 3-5; the bench asserts its own 14 a frame)
    b7_main = [r for r in b7_rows if r["main"]]
    b7_n = [r["per_frame"] for r in b7_main]
    b7 = KERNEL_NAMES.index("B7")
    b7_launches = slice_launches["B7"] + sum(
        run["launches"][b7] for run in (*runs.values(), mesh_run))
    for r in b7_main:
        print(f"exact_backwarp {r['level']} {r['kind']} x{r['per_frame']} "
              f"a frame: kernel_ms {_ms_text(r['kernel_ms'])} each")
    print(f"exact_backwarp per frame ({sum(b7_n)} launches): device_ms "
          f"{_per_frame(b7_main, 'device_ms', b7_n):.5f}, kernel_ms "
          f"{_ms_text(_per_frame(b7_main, 'kernel_ms', b7_n))}, bound "
          f"{_per_frame(b7_main, 'bound_ms', b7_n):.5f}, call "
          f"{_per_frame(b7_main, 'call_ms', b7_n):.4f} (host-inclusive), "
          f"plain {_per_frame(b7_main, 'plain_ms', b7_n):.4f} "
          f"({_per_frame(b7_main, 'plain_ops', b7_n)} ATen ops), grid_sample "
          f"{_per_frame(b7_main, 'library_ms', b7_n):.5f} (kernel_ms "
          f"{_ms_text(_per_frame(b7_main, 'library_kernel_ms', b7_n))}); "
          f"{b7_launches} launches on the main path")
    record["kernels"].append({
        "name": "exact_backwarp",
        "route": "cuda",
        "source": "transflow_tpu_torch/csrc/exact_backwarp.cu",
        "replaces": "transflow_tpu/flow/estimators/liteflownet.py:106",
        "replaces_function": "liteflownet.py:106 backwarp, its unbounded "
                             "path (:162-196, jnp ops)",
        "launches": b7_launches,
        "max_abs_err": max(r["err"] for r in b7_rows),
        # per frame at bound 0: 9 feature warps, 5 image warps
        "ms": _per_frame(b7_main, "device_ms", b7_n),
        "device_ms": _per_frame(b7_main, "device_ms", b7_n),
        "kernel_ms": _per_frame(b7_main, "kernel_ms", b7_n),
        "call_ms": _per_frame(b7_main, "call_ms", b7_n),
        "plain_ms": _per_frame(b7_main, "plain_ms", b7_n),
        "bound_ms": _per_frame(b7_main, "bound_ms", b7_n),
        "bound_by": _bound_by(b7_main),
        "library_ms": _per_frame(b7_main, "library_ms", b7_n),
        "library_kernel_ms": _per_frame(b7_main, "library_kernel_ms", b7_n),
        "library": "torch.nn.functional.grid_sample (bilinear, zeros, "
                   "align_corners=True) on an f32 NCHW view; both timed on "
                   "flows whose taps stay in the frame",
    })
    # B16 and B17 per frame: the six float32 upsamples, the five tap
    # applies (bf16 distances); their launches: the slice's and phases
    # 4-5's Engines' (the bench asserts its own 6 and 5 a frame)
    heads = {
        "upsample2x_phases": (
            "B16", up_rows, "transflow_tpu/flow/estimators/liteflownet.py:220",
            "liteflownet.py:220 _upsample2x_phases (jnp ops): the flow at "
            "L5-L2 and the cost volume at L3 and L2"),
        "reg_apply": (
            "B17", reg_rows, "transflow_tpu/flow/estimators/liteflownet.py:420",
            "liteflownet.py:420-448 Regularization's softmax and fused tap "
            "apply (jnp ops)")}
    for name, (label, group, replaces, function) in heads.items():
        main = [r for r in group if r["main"]]
        k = KERNEL_NAMES.index(label)
        launches = slice_launches[label] + sum(
            run["launches"][k] for run in (*runs.values(), mesh_run))
        library = ("" if label == "B17" else
                   f", conv_transpose2d {_per_frame(main, 'library_ms'):.5f} "
                   f"(kernel_ms "
                   f"{_ms_text(_per_frame(main, 'library_kernel_ms'))})")
        print(f"{name} per frame ({len(main)} launches): device_ms "
              f"{_per_frame(main, 'device_ms'):.5f}, kernel_ms "
              f"{_ms_text(_per_frame(main, 'kernel_ms'))}, bound "
              f"{_per_frame(main, 'bound_ms'):.5f}, call "
              f"{_per_frame(main, 'call_ms'):.4f} (host-inclusive), plain "
              f"{_per_frame(main, 'plain_ms'):.4f} "
              f"({_per_frame(main, 'plain_ops')} ATen ops){library}; "
              f"{launches} launches on the main path")
        entry = {
            "name": name,
            "route": "cuda",
            "source": "transflow_tpu_torch/csrc/lfn_heads.cu",
            "replaces": replaces,
            "replaces_function": function,
            "launches": launches,
            "max_abs_err": max(r["err"] for r in group),
            "ms": _per_frame(main, "device_ms"),
            "device_ms": _per_frame(main, "device_ms"),
            "kernel_ms": _per_frame(main, "kernel_ms"),
            "call_ms": _per_frame(main, "call_ms"),
            "plain_ms": _per_frame(main, "plain_ms"),
            "plain_ops": _per_frame(main, "plain_ops"),
            "bound_ms": _per_frame(main, "bound_ms"),
            "bound_by": _bound_by(main),
            "library_ms": None,
            "library": "none: no single PyTorch call takes the softmax over "
                       "the taps and applies them to the flow",
        }
        if label == "B16":
            entry["library_ms"] = _per_frame(main, "library_ms")
            entry["library_kernel_ms"] = _per_frame(main, "library_kernel_ms")
            entry["library"] = ("torch.nn.functional.conv_transpose2d "
                                "(stride 2, padding 1, groups C; cuDNN, TF32 "
                                "off) on an f32 NCHW view")
        record["kernels"].append(entry)
    # B18 per frame: each B18_FRAME entry's path row (bf16, its layout and
    # leaky ReLU) times its launches a frame; its launches: the slice's and
    # phases 4-5's Engines' (the bench asserts its own 93 a frame)
    b18_main = [r for r in b18_rows if r["main"]]
    b18_n = [r["count"] for r in b18_main]
    b18 = KERNEL_NAMES.index("B18")
    b18_launches = slice_launches["B18"] + sum(
        run["launches"][b18] for run in (*runs.values(), mesh_run))
    print(f"conv_epilogue per frame ({sum(b18_n)} launches): device_ms "
          f"{_per_frame(b18_main, 'device_ms', b18_n):.5f}, kernel_ms "
          f"{_ms_text(_per_frame(b18_main, 'kernel_ms', b18_n))}, bound "
          f"{_per_frame(b18_main, 'bound_ms', b18_n):.5f}, call "
          f"{_per_frame(b18_main, 'call_ms', b18_n):.4f} (host-inclusive), "
          f"plain {_per_frame(b18_main, 'plain_ms', b18_n):.4f} "
          f"({_per_frame(b18_main, 'plain_ops', b18_n)} ATen ops); the ops "
          f"it replaced: device_ms "
          f"{_per_frame(b18_main, 'replaced_ms', b18_n):.5f}, kernel_ms "
          f"{_ms_text(_per_frame(b18_main, 'replaced_kernel_ms', b18_n))} "
          f"({_per_frame(b18_main, 'replaced_ops', b18_n)} ATen ops); "
          f"{b18_launches} launches on the main path")
    record["kernels"].append({
        "name": "conv_epilogue",
        "route": "cuda",
        "source": "transflow_tpu_torch/csrc/conv_epilogue.cu",
        "replaces": "transflow_tpu/flow/estimators/liteflownet.py:60",
        "replaces_function": "liteflownet.py:60 _conv (flax nn.Conv's bias "
                             "add after the bf16 convolution) and :47 "
                             "_leaky (jnp ops)",
        "launches": b18_launches,
        "max_abs_err": max(r["err"] for r in b18_rows),
        # per frame: the 93 launches of B18_FRAME
        "ms": _per_frame(b18_main, "device_ms", b18_n),
        "device_ms": _per_frame(b18_main, "device_ms", b18_n),
        "kernel_ms": _per_frame(b18_main, "kernel_ms", b18_n),
        "call_ms": _per_frame(b18_main, "call_ms", b18_n),
        "plain_ms": _per_frame(b18_main, "plain_ms", b18_n),
        "plain_ops": _per_frame(b18_main, "plain_ops", b18_n),
        "bound_ms": _per_frame(b18_main, "bound_ms", b18_n),
        "bound_by": _bound_by(b18_main),
        "library_ms": None,
        "library": "none: no single PyTorch call adds a bias and takes a "
                   "leaky ReLU; replaced_ms is the ops it replaced (the "
                   "bias cast, the add on the permuted view, the leaky ReLU)",
        "replaced_ms": _per_frame(b18_main, "replaced_ms", b18_n),
        "replaced_kernel_ms": _per_frame(b18_main, "replaced_kernel_ms",
                                         b18_n),
    })
    fb_sources = {"poly_expansion": "farneback.py:74 poly_expansion",
                  "update_equations": "farneback.py:102 _update_flow, "
                                      "warp and normal equations",
                  "aggregate_solve": "farneback.py:149 _update_flow, "
                                     "window sums and solve"}
    for k, (name, group) in enumerate(fb_main.items()):
        weight = [FB_PER_LEVEL[name]] * len(group)
        record["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": "transflow_tpu_torch/csrc/farneback.cu",
            "replaces": "transflow_tpu/flow/estimators/"
                        + fb_sources[name].split(" ")[0],
            "replaces_function": fb_sources[name],
            # the four Farneback Engine runs'
            "launches": sum(run["launches"][3 + k]
                            for run in fb_runs.values()),
            "max_abs_err": max(r["err"] for r in fb_rows
                               if r["kernel"] == name),
            # per frame: the four levels at FB_PER_LEVEL launches each
            "ms": _per_frame(group, "device_ms", weight),
            "device_ms": _per_frame(group, "device_ms", weight),
            "kernel_ms": _per_frame(group, "kernel_ms", weight),
            "call_ms": _per_frame(group, "call_ms", weight),
            "plain_ms": _per_frame(group, "plain_ms", weight),
            "bound_ms": _per_frame(group, "bound_ms", weight),
            "bound_by": _bound_by(group),
            "library_ms": None,
            "library": "none: hand-written for jnp code (no Pallas source); "
                       "no single PyTorch call computes it",
        })
    # B8 per frame: the pyramid of a bf16 frame (three levels, both images)
    # in one launch; B14 per frame: lukas-kanade.json's pyramid (the
    # frames' casts and two reduces) in one launch
    b8_index, b14_index = KERNEL_NAMES.index("B8"), KERNEL_NAMES.index("B14")
    pyramid_groups = {
        "pyramid_levels": (
            [r for r in fb_rows if r["kernel"] == "pyramid_levels"
             and r["main"]],
            # phase F's Engine runs, phase T's Engine and CLI runs
            sum(run["launches"][b8_index] for run in fb_runs.values())
            + t_run["launches"][b8_index] + t_run["cli_launches"][b8_index],
            "transflow_tpu/flow/estimators/farneback.py:243",
            "farneback.py:243-248 farneback's pyramid level, "
            "jax.image.resize(gaussian_blur(img, sigma), (lh, lw), "
            "'linear'), and :211-213 the fb_downscale pre-resize",
            [r for r in fb_rows if r["kernel"] == "pyramid_levels"]),
        "lk_pyramid": (
            [r for r in h_rows if r["kernel"] == "lk_pyramid"],
            # phase H's Engine runs of the Lucas-Kanade presets
            sum(run["launches"][b14_index] for run in h_runs.values()),
            "transflow_tpu/ops/image.py:234",
            "ops/image.py:234 downsample2x at each level of "
            "flow/estimators/lucas_kanade.py:71-78's pyramid, and its "
            "astype(float32) of both frames",
            [r for r in h_rows
             if r["kernel"] in ("lk_pyramid", "downsample2x")])}
    for name, (group, launches, replaces, function, every) in \
            pyramid_groups.items():
        print(f"{name} per frame ({len(group)} launches): device_ms "
              f"{_per_frame(group, 'device_ms'):.5f}, kernel_ms "
              f"{_ms_text(_per_frame(group, 'kernel_ms'))}, bound "
              f"{_per_frame(group, 'bound_ms'):.5f}, call "
              f"{_per_frame(group, 'call_ms'):.4f} (host-inclusive), plain "
              f"{_per_frame(group, 'plain_ms'):.4f}; the path it replaced: "
              f"device_ms {_per_frame(group, 'replaced_ms'):.5f}, kernel_ms "
              f"{_ms_text(_per_frame(group, 'replaced_kernel_ms'))}; "
              f"{launches} launches on the main path")
        record["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": "transflow_tpu_torch/csrc/pyramid.cu",
            "replaces": replaces,
            "replaces_function": function,
            "launches": launches,
            "max_abs_err": max(r["err"] for r in every),
            "ms": _per_frame(group, "device_ms"),
            "device_ms": _per_frame(group, "device_ms"),
            "kernel_ms": _per_frame(group, "kernel_ms"),
            "call_ms": _per_frame(group, "call_ms"),
            "plain_ms": _per_frame(group, "plain_ms"),
            "bound_ms": _per_frame(group, "bound_ms"),
            "bound_by": _bound_by(group),
            "library_ms": None,
            "library": "none: no single PyTorch call blurs and resizes; "
                       "the path it replaced is replaced_ms (B8: two cuDNN "
                       "passes and a resize an image and level; B14: the "
                       "frames' casts and a reduce a level)",
            "replaced_ms": _per_frame(group, "replaced_ms"),
            "replaced_kernel_ms": _per_frame(group, "replaced_kernel_ms"),
        })
    b5_main = next(r for r in b5_rows if r["flow"] == "farneback pan")
    print(f"forward_to_backward per frame (one call on the pan's forward "
          f"flow): device_ms {b5_main['device_ms']:.5f}, kernel_ms "
          f"{_ms_text(b5_main['kernel_ms'])}, bound "
          f"{b5_main['bound_ms']:.5f}, call {b5_main['call_ms']:.4f} "
          f"(host-inclusive), plain {b5_main['plain_ms']:.4f}")
    record["kernels"].append({
        "name": "forward_to_backward",
        "route": "cuda",
        "source": "transflow_tpu_torch/csrc/scatter.cu",
        "replaces": "transflow_tpu/ops/scatter.py:29",
        "replaces_function": "scatter.py:29 scatter_last_wins, as "
                             "flow/transforms.py:33 forward_to_backward "
                             "runs it",
        # phase T's Engine and CLI runs (two kernel launches a call)
        "launches": t_run["launches"][6] + t_run["cli_launches"][6],
        "max_abs_err": max(r["err"] for r in b5_rows),
        # per frame: one call on Farneback's forward flow on the pan
        "ms": b5_main["device_ms"],
        "device_ms": b5_main["device_ms"],
        "kernel_ms": b5_main["kernel_ms"],
        "call_ms": b5_main["call_ms"],
        "plain_ms": b5_main["plain_ms"],
        "bound_ms": b5_main["bound_ms"],
        "bound_by": b5_main["bound_by"],
        "library_ms": None,
        "library": "none: index_put_ with duplicate indices picks a "
                   "writer in no fixed order on CUDA, so it is not the "
                   "same function",
    })
    h_sources = {
        "hs_derivatives": ("csrc/horn_schunck.cu",
                           "horn_schunck.py:41 horn_schunck, the pre-blur "
                           "and derivatives (:34-36, :45-56)"),
        "hs_iterate": ("csrc/horn_schunck.cu",
                       "horn_schunck.py:62 horn_schunck's while_loop body "
                       "and early stop (:58-76)"),
        "lk_warp_products": ("csrc/lucas_kanade.cu",
                             "lucas_kanade.py:49 _lk_level's loop body, the "
                             "warp and products (:50-54)"),
        "lk_window_solve": ("csrc/lucas_kanade.cu",
                            "lucas_kanade.py:36 _lk_level's window sums "
                            "and solves (:36-42, :53-60)")}
    h_launches = {"hs_derivatives": KERNEL_NAMES.index("B9"),
                  "hs_iterate": KERNEL_NAMES.index("B10"),
                  "lk_warp_products": KERNEL_NAMES.index("B11"),
                  "lk_window_solve": KERNEL_NAMES.index("B12")}
    for name, (source, function) in h_sources.items():
        kernels = ("lk_structure_tensor", name) \
            if name == "lk_window_solve" else (name,)
        group = [r for r in h_rows if r["kernel"] in kernels]
        weight = [H_PER_LEVEL[r["kernel"]] for r in group]
        print(f"{name} per frame ({sum(weight)} launches): device_ms "
              f"{_per_frame(group, 'device_ms', weight):.5f}, kernel_ms "
              f"{_ms_text(_per_frame(group, 'kernel_ms', weight))}, bound "
              f"{_per_frame(group, 'bound_ms', weight):.5f}, call "
              f"{_per_frame(group, 'call_ms', weight):.4f} "
              f"(host-inclusive), plain "
              f"{_per_frame(group, 'plain_ms', weight):.4f}")
        record["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": f"transflow_tpu_torch/{source}",
            "replaces": "transflow_tpu/flow/estimators/"
                        + function.split(" ")[0],
            "replaces_function": function,
            # phase H's Engine runs of the five presets, phase S's timed
            # chunk and phase M's (both processes)
            "launches": sum(run["launches"][h_launches[name]]
                            for run in h_runs.values())
            + s_run["launches"][h_launches[name]]
            + m_run["launches"][h_launches[name]],
            "max_abs_err": max(r["err"] for r in group),
            # per frame: horn-schunck.json's launches at 1080p, or
            # lukas-kanade.json's over its three levels
            "ms": _per_frame(group, "device_ms", weight),
            "device_ms": _per_frame(group, "device_ms", weight),
            "kernel_ms": _per_frame(group, "kernel_ms", weight),
            "call_ms": _per_frame(group, "call_ms", weight),
            "plain_ms": _per_frame(group, "plain_ms", weight),
            "bound_ms": _per_frame(group, "bound_ms", weight),
            "bound_by": _bound_by(group),
            "library_ms": None,
            "library": "none: hand-written for jnp code (no Pallas source); "
                       "no single PyTorch call computes it",
        })
    # the compositor's kernels: F's Engine runs, T's Engine and CLI runs,
    # H's and S's (K0 runs in T alone; the meshes of phases 5 and M
    # update through the plain ops)
    c_sources = {
        "K0": ("leave_empty_sources", "transflow_tpu/ops/scatter.py:13",
               "scatter.py:13 scatter_any, as compositor/core.py:224-230 "
               "_movement runs it for moving_pixels_leave_empty_spot"),
        "K1": ("layer_update", "transflow_tpu/compositor/core.py:351",
               "compositor/core.py:351 update_moveref and :363 update_sum: "
               "_movement (:154), _reset with jax.random.uniform (:268), "
               "_reference_rgba (:321)"),
        "K2": ("composite", "transflow_tpu/compositor/core.py:457",
               "compositor/core.py:457 render_layer over "
               "build_compositor's render_fn (:533)")}
    c_main = {"K0": "F pan", "K1": "F pan", "K2": "F layer"}
    main_runs = [*fb_runs.values(), *h_runs.values()]
    for kernel, (name, replaces, function) in c_sources.items():
        k = KERNEL_NAMES.index(kernel)
        row = next(r for r in c_rows
                   if r["kernel"] == kernel and r["input"] == c_main[kernel])
        launches = (sum(run["launches"][k] for run in main_runs)
                    + t_run["launches"][k] + t_run["cli_launches"][k]
                    + s_run["launches"][k])
        print(f"{name} ({kernel}) per frame ({c_main[kernel]}): "
              f"device_ms {row['device_ms']:.5f}, kernel_ms "
              f"{_ms_text(row['kernel_ms'])}, bound {row['bound_ms']:.5f}, "
              f"call {row['call_ms']:.4f} (host-inclusive), plain "
              f"{row['plain_ms']:.4f}; {launches} launches on the main path")
        record["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": "transflow_tpu_torch/csrc/compositor.cu",
            "replaces": replaces,
            "replaces_function": function,
            "launches": launches,
            "max_abs_err": max(r["err"] for r in c_rows
                               if r["kernel"] == kernel),
            "ms": row["device_ms"],
            "device_ms": row["device_ms"],
            "kernel_ms": row["kernel_ms"],
            "call_ms": row["call_ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,
            "library": "none: hand-written for jnp code (no Pallas source); "
                       "no single PyTorch call computes it",
        })
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
