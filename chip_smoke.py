"""Smoke run of the PyTorch/CUDA port (freepose_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each on stdout:
  1. build   every hand-written kernel (csrc/raster_tile.cu,
             csrc/flash_attention.cu, csrc/flash_attention_sm90.cu) with
             nvcc, one process per source, started together; ptxas lines;
  2. k2      the whole-K/V attention kernel (bf16 d 64: the wgmma + TMA
             kernel) against its plain PyTorch version at the DINOv2-L
             shapes of the paths (bank batch 128 and batch 8, a static frame
             of 4 proposals, a video frame's 1 and 2 retrieval crops; H 16,
             n 905, d 64, bf16), a ragged length and fp32, with the
             configuration the split rule picks at each; at each crop batch
             also both d 64 builds (64- and 192-row blocks), checked and
             timed; kernel, plain and scaled_dot_product_attention times;
  3. k2_d72, k2_d256, k3, k4
             the attention kernels at the video path's shapes against their
             plain versions: K2 at the Hiera-L global blocks [1, 8, 4096, 72]
             and SAM2 memory self-attention [2, 1, 4096, 256]; K3 (the
             streaming regime, no mask) at [1, 1, 4096, 256] x 6,144 keys; K4
             at the memory cross-attention [2, 1, 4096, 256] x 28,736 keys
             with whole memory slots masked. All four run the wgmma + TMA
             kernel (K2 d 256, K3 and K4 with their key splits and the
             combine kernel, which is held against its plain version on the
             same partials); kernel, plain and SDPA times (SDPA with
             attn_mask for K4), and at d 72 its three block sizes and for K4 1-8 key splits checked
             and timed (configs). Every attention check also shows that its
             tolerance fails the plain version of a kernel that drops keys
             (the last 64; for K4 the object pointers, or one memory slot);
             checks on a ragged key count also fail a kernel that reads the
             next head's K/V rows into the ragged tile (what a 2-D tensor map
             would do). K4 adds ragged mask runs (which also fail a kernel
             that skips partially masked tiles), a batch element with every
             key masked (the uniform mean of its V; a kernel that writes 0
             there fails), its list kernel against key_tile_list (identical)
             and the key tiles it processes at the smoke's mask;
  4. k5      the biased fp32 attention kernel (register-tiled) against its
             plain version at the ZoeD_N shape [1, 16, 577, 64] and
             [2, 16, 577, 64] (the bias [16, 577, 577] shared across the
             batch), each with and without a key mask, at the key split
             count k5_config picks; the tolerance must fail the plain version
             without the bias and with the next head's; each split count
             checked and timed (configs); kernel, plain and SDPA (attn_mask =
             the bias) times, CUDA events and profiler device times;
  5. k1      the raster tile kernel against its plain version on a seeded
             16k-face coloured mesh, one 128-pose chunk at 420², tile 28,
             M 256, from per-face rows and per-tile slot indices: hit-mask
             mismatches, depth/rgb error (colour and depth_only); a plain
             stand-in that gathers a slot from the next pose's rows must
             fail the gate; the prologue's time by part (projection,
             binning, face rows), the kernel's, the whole chunk's
             (rasterize_cuda) and the plain version's;
  6. main    the static coarse-pose path at full width: DINOv2-L/14-reg
             truncated at layer 22, bf16, seeded random weights in the JAX
             package's layout carried over by dinov2_from_jax;
             TemplateBank.build_pack of the mesh (600 views through the raster
             kernel, 600 crops through the ViT in batches of 128,
             depth_stats); estimate_batch on 4 proposals cut from a rendered
             frame. Launch counts are zeroed before the pack build, read after
             the frame, and must be > 0 for K1, K2 and the wgmma + TMA kernel
             (`launch.sm90`); then a torch.profiler breakdown of
             one ViT batch and one frame;
  7. video   the video proposal path at full width through its CLI
             (extract_proposals_ground_video --detector boxes): a seeded
             10-frame 1280x720 video with 2 boxed objects, SAM2 Hiera-L at
             1024², bf16, seeded random weights carried over by
             sam2_video_from_jax, DINOv2-L layer 22 retrieval against a
             seeded 46,000 x 1024 mesh bank. Launch counts are zeroed before
             the CLI and read after it (K2, K4, the wgmma + TMA kernel and its
             combine, which memory self-attention's key split runs, must be
             > 0); proposals and tracks counted (> 0 proposals). Then, on the
             same path's
             functions: ms per frame of SAM2 propagation and of retrieval,
             kernel launches per frame (3 K2 in the trunk on every frame, 4
             K2 + 4 K4 in memory attention on every frame that reads memory),
             a torch.profiler breakdown and idle share of one frame, and the
             mask IoU and low-res logit difference against the same
             propagation with every attention call on its plain version;
  8. scale   the metric scale path at full width through its CLI
             (compute_scale_video) on the video phase's frames and proposal
             JSON: CLIP ViT-bigG/14 (seeded random weights drawn on the
             card), ZoeD_N from a .npz of seeded random parameters in the JAX
             layout (carried over by zoedepth_from_jax), a seeded 2,201-name
             prior, k = 11, all fp32. Launch counts are zeroed before the CLI
             and read after it: K5 must launch 24 times per depth forward;
             every proposal gets a finite scale > 0, one per track. Then, on
             the same functions: ZoeD_N ms per frame, CLIP ms per proposal,
             seconds to encode the prior, depth_scales ms per mask, a
             torch.profiler breakdown of one depth forward, and one frame's
             depth against the same forward with every biased attention on
             its plain version;
  9. refine  the video fine refine at full width through its CLIs: the
             torus written under each mesh name of the scale phase's
             scaled.json, render_templates on those names (600 views at
             420²), then dino_inference_video with its defaults (DINOv2-L
             layer 22 bf16, a 20,000-pose fine grid, a 15° neighbourhood of
             at most 32 views, a 256-slot cache per track, each track an
             AutoRefineChain with a stream miss bucket of 16 and lag 3).
             Launch counts are zeroed before the CLIs and read after them
             (K1, K2 at d 64 and the wgmma + TMA kernel must be > 0); one
             finite row per scaled proposal, R orthonormal, t_z > 0. The
             same CLI with --chain-refine 0: rows and grid poses against the
             chain's. Then, on the same functions: ms per hit and per miss
             frame (median over frames ≥ 2), misses per frame, full
             re-dispatches and bucket switches, a torch.profiler breakdown
             of one hit step and one miss step, one view's features alone
             against inside a 17-crop batch, and frame 1 of the first track
             from a cold cache with the kernels and with every attention
             call and K1 on their plain versions: render masks identical,
             the 32 scores within REFINE_SCORE_ATOL, which scores read one
             slot off must fail;
 10. smooth  the track refine at full width through its CLIs on the earlier
             phases' files: the frames that the scale phase's longest track
             covers from frame 0 on (one proposal each) and that object's
             GT boxes, filter_predictions on scaled.json (one track kept,
             one proposal per frame), dino_inference_video on it (one
             coarse row per frame), then
             smooth_poses_video with the ZNCC chain (its default) and with
             CoTracker2 (COTRACKER2: 384x512, windows of 8, hidden 384, 6
             iterations, fp32) from a .npz of seeded random parameters;
             DINOv2-B at 518² bf16, K1 at 518² with tile 37, --interval 12,
             --cap 512. Launch counts are zeroed before the CLIs and read
             after them (K1 and K2 at d 64 must be > 0); one row per frame
             in each tracked CSV, R orthonormal, t finite with t_z > 0.
             Then, on the same functions: confidence ms per frame,
             correspondences, ZNCC, CoTracker2 and EPnP ms per interval,
             smoothing ms, torch.profiler breakdowns of one confidence
             chunk and one CoTracker2 interval; one 8-frame confidence
             chunk with the kernels against every attention call and K1 on
             their plain versions (render masks identical, depth within
             K1_ATOL, DINOv2-B patch features of min cosine >= 0.99, the
             chunk's inlier counts of both); K1 on that chunk against its
             plain version (the next-pose stand-in must fail) and K2 at
             [16, 12, 1374, 64] against its plain version (the dropped-keys
             and next-head stand-ins must fail), each with its times, bound
             and, for K2, SDPA's;
 11. proposals the static proposal path at full width through its CLIs:
             extract_retrieval_features on the refine phase's 600-view
             template shards, then merge_features; a seeded 3-image BOP
             test split at 640x480; extract_proposals_ground --detector
             grounding (GroundingDINO-B at 800², SAM2 Hiera-L at 1024²,
             DINOv2-L layer 22, all bf16, --topk 0, from .npz files of
             seeded weights in the JAX layout) against the video phase's
             46,000 x 1024 bank, its box threshold taken from a first detect
             on image 0 so that ~16 boxes pass. Launch counts are zeroed
             before the bank CLI and read after the proposal CLI (K2 at d 64
             and at d 72 must be > 0); at least one proposal per image,
             finite boxes of positive size centred in the image, non-empty
             masks, meshes from the filelist, the bank's [600, 1024] view
             features. Then, on the same functions: ms per image of
             detection, SAM2 and retrieval, torch.profiler breakdowns of one
             GroundingDINO forward (with the device time inside the
             deformable attention, Swin, BERT and fusion modules) and one
             SAM2 image step, the same image detected twice (identical
             boxes), and image 0's SAM2 masks (mean IoU >= 0.9) and
             retrieval features (min cosine >= 0.99) against the same calls
             with every attention call on its plain version;
 12. eval    the BOP evaluation path at full width through its CLI
             (eval_bop_pose --errors cus chamfer chamfer_proj mssd mspd
             vsd): a seeded 3-image BOP split at 640x480 with LM-O's
             intrinsics, two instances per image of the torus (8,192
             vertices, 16,384 faces: the MaskRenderer's caps) as
             models/obj_000001.ply in mm, depth PNGs rendered at the GT
             poses, visib_fract, and a CSV of 4 estimates of instance 0
             per image (the GT pose, 5° and 30° off, shifted 5 cm; the unit
             torus with its scale). The CLI runs with the MaskRenderer on
             K1 (one pose per render at 640², tile 32, 256 faces per tile,
             depth only) and again on the plain rasterizer: launches
             zeroed before and read after the K1 run (K1 > 0, one launch
             per render, none in the plain run); every per-pair cus
             identical; AR_cus, AR_chamfer,
             AR_chamfer_proj, AR_mssd and AR_mspd equal, every per-pair vsd
             within EVAL_VSD_ATOL and AR_vsd within EVAL_AR_VSD_ATOL, the
             GT estimate's cus < 0.01 and the 30° one's > 0.1, 0 < AR < 1.
             Then K1 at that shape against its plain version (identical
             hit masks, depth within K1_ATOL; a stand-in that drops each
             tile's first slot must fail), timed: CUDA events, profiler
             device time, the prologue by part, one render, the plain
             version and the bound;
 13. vos     semi-supervised VOS at full width through its CLI
             (vos_inference: SAM2 Hiera-L at 1024², bf16, seeded random
             weights with the object-score bias) on the video phase's 10
             frames at 1280x720, prompted with the two objects' frame-0
             masks as drawn in one palette PNG, on the kernels: launches
             zeroed before and read after (K2 d 72, K2 d 256 and K4 > 0);
             every frame's PNG holds both object ids; then mask-prompted
             propagation per frame on the same functions with the kernels
             and with plain attention, gated on frames 1-9 (frame 0 is the
             prompt): each object's own mask (before the non-overlap
             constraint) with mean IoU >= VIDEO_IOU_MIN and every IoU >=
             VOS_IOU_FLOOR, each object's J&F (the CLI's metric) >=
             VOS_JF_MIN, low-res logits within VIDEO_LOGIT_ATOL;
 14. texture textured template assets at full width through their entry
             points: a seeded UV torus written as OBJ + MTL + 2,048² PNG
             atlas (8,125 vertices and 15,872 faces with its seams split),
             load_obj gated to keep the atlas and the UVs (host seconds
             logged); a torch.hub-layout DINOv2-L/14-reg .pth through
             convert_weights --kind dinov2-hub (the .npz bit-equal to the
             seeded tree) and prepare_weights on a directory holding only it
             ("1 families ready, 6 missing", the same .npz); render_templates
             (600 textured views at 420²: K1 carries each UV pass), the
             textured TemplateBank.build_pack cold and warm (the baked pack's
             warm time beside it) and extract_retrieval_features --weights
             <the converted .npz> on the shard. Launch counts are zeroed
             before render_templates and read after the bank CLI (K1 and K2
             at d 64 must be > 0). Then K1 on the first 128-pose chunk of the
             UV pass against its plain version (identical hit masks, depth
             and (u, v, w) within K1_ATOL; the next-pose stand-in must fail);
             the shading pass timed per chunk beside its bound, textured RGB
             against the bake (most hit pixels must differ); the pack and the
             bank CLI with every kernel on its plain version (no K1 or K2
             launch; pack patch and view features of min cosine >=
             FEATURE_COS_MIN); resize_meshes on the mesh directory (unit
             half-extent, centre at zero) and merge_results on two CSVs cut
             from the refine phase's (the rows equal);
 15. coupled the coupled video step at full width (no CLI reaches it; the
             functions a user chains): synthetic_video()'s 10 frames staged
             on the card in one upload (stage_frames_hbm, a 128-frame
             bucket), object 0 prompted by its frame-0 box, SAM2 Hiera-L at
             1024² bf16 through propagate_batched (chunk 8: batches [0],
             [1..8], [9]), each batch's masks and frames through
             proposals_from_masks_video (420² crops), frame 0's coarse pose
             from the torus's 600-view pack, frames 1-9 through an
             AutoRefineChain with the refine phase's settings, and a
             StreamingInliers (DINOv2-B at 518², chunks of 8) fed as the
             chain finalises poses. Launch counts zeroed before the step and
             read after it (K1, K2 at d 64, 72 and 256, K4 > 0). Gates: the
             batches' masks equal propagate_in_video(binarize=True)'s, bit
             for bit; the batches' frames equal the staged video; crops
             within COUPLED_CROP_ATOL, mask crops and bboxes identical to the
             host path (extract_proposals on the fetched mask); the chain's
             poses and scores within COUPLED_POSE_ATOL of the same chain fed
             from the host path; StreamingInliers identical to
             n_inliers_per_pose; on frames 1-2, kernels vs plain versions:
             SAM2 mask IoU >= VIDEO_IOU_MIN, each frame's cold refine step
             with render masks identical and scores within
             REFINE_SCORE_ATOL (scores read one slot off must fail). Prints
             ms per frame (median of frames 1-9), its SAM2 and refine parts,
             device busy against profiled wall time and launches per frame,
             and host-to-device copies per frame;
 16. stride  SAM2 with memory_temporal_stride STRIDE at full width: both
             objects box-prompted on frame 0, Hiera-L bf16, frame at a time
             on the kernels (launches zeroed before and read after: K2 d 72
             and d 256 and K4 > 0; the stride changes K4's mask), then on
             the plain attention. Gates: the memory frames held after every
             step equal the reference's stride-r selection; each object's
             own mask on frames 1-9 with mean IoU >= VIDEO_IOU_MIN and every
             IoU >= VOS_IOU_FLOOR. Prints ms per frame beside the video
             phase's stride-1 figure;
 17. amg     Sam2AutomaticMaskGenerator on frame 0 of synthetic_video():
             Hiera-L at 1024² bf16, 32 x 32 points in 16 batches of 64,
             multimask, box NMS 0.7, its IoU and stability thresholds taken
             from a first pass's candidates (random weights sit far below
             the defaults). Launch counts zeroed before one generate and
             read after it (K2 d 72 > 0). Gates: 16 batches; batch 0's
             pre-filter outputs, kernels vs plain attention: masks mean IoU
             >= VIDEO_IOU_MIN, IoU predictions and stability within
             AMG_SCORE_ATOL; 1 to AMG_MAX_RECORDS records, each RLE area
             equal to its mask's sum and each box to its mask's box; no two
             kept boxes above the NMS threshold. Prints seconds per image,
             split into the encoder, the decode batches and the host's
             filters, RLE and NMS, and device busy against wall time;
 18. leftovers the leftovers of slices B and D and the viz CLIs, each
             through the entry points a user calls, with the launch counts
             zeroed before the first and read after the last (K1 and K2 at
             d 64 > 0): the serial refine_cached loop on a 10-frame walk of
             torus renders on the 20,000-pose grid (DINOv2-L layer 22 bf16,
             420² renders, 8 neighbours, 12 slots: hits, misses, evictions);
             smooth_track(batched_intervals=True) on the smooth phase's
             staged frames and coarse rows (DINOv2-B at 518², ZNCC, cap
             512); the learned CoTracker at CoTrackerConfig() on 12 frames
             of the video (its 10 and the last repeated) at 1280x720 with
             512 seeded queries, from seeded random parameters; the
             vis_poses_video CLI on the video's frames and every row of
             the refine phase's CSV (one K1 call at 480², tile 32, P =
             rows) and the vis_features CLI on 3 of those frames
             (DINOv2-L at 518², layer 22: K2 d 64 at [1, 16, 1374, 64]).
             Gates: one refine step kernels vs plain as in the refine
             phase, from the walk's frame 1 pose; batched intervals within
             BATCHED_POSE_ATOL of the pipelined path, and StreamingInliers'
             counts through inliers= giving the computed path's rows
             exactly; the learned tracks finite, the query frame pinned,
             visibility in [0, 1], and a 2-frame 64-query cut on the card
             within LEARNED_TRACK_ATOL of the CPU, which the CPU run with
             one iteration fewer must fail; one overlay per distinct frame
             (a later row of a frame overwrites its JPEG, as in the JAX
             CLI), every row rendered, and the K1
             call's masks identical to the plain rasterizer's; 3 panels,
             and the features with K2 of min cosine >= FEATURE_COS_MIN
             against plain attention, K2 at [1, 16, 1374, 64] against its
             plain version. Prints ms per hit frame of AutoRefineChain and
             the serial loop with launches per frame,
             both smooth paths' ms per video and K1's P, the learned
             tracker's ms per interval and device busy share, ms per
             overlay row, and K2's times with SDPA's and the bound;
 19. mesh    the multi-GPU paths on a device mesh of four shards on the
             one card (make_mesh(data=2, model=2, devices=[cuda:0] * 4)),
             each through the entry points a user calls, with the launch
             counts zeroed before the first and read after the last (K1,
             K2 at d 64, 72 and 256 and K4 > 0): (a) topk_search_sharded
             over a seeded 46,037 x 1,024 bank (the Objaverse+GSO count,
             padded to the "model" axis); (b) refine_sharded at the refine
             cell's widths (DINOv2-L layer 22 bf16, 420² renders, 32
             neighbours) on this mesh (16 views per shard) and on
             make_mesh(data=1, model=4) (8 per shard); (c) the cached
             composition (misses sharded) on the leftovers phase's walk;
             (d) object-sharded SAM2 Hiera-L propagation of the video's two
             boxed objects over "data"; (e) smooth_track(device_mesh=) on
             the smooth cell (ZNCC, DINOv2-B at 518²); (f)
             dino_inference_video --shard-refine and
             extract_proposals_ground_video --shard-objects on the earlier
             phases' inputs (one card: a one-shard mesh). Gates: (a)
             indices identical to topk_search on the whole bank and scores
             within MESH_TOPK_ATOL, which a stand-in that drops the shards'
             row offsets must fail; (b) against refine() on the card,
             render masks identical, the 32 scores within
             REFINE_SCORE_ATOL and the lifted pose within MESH_POSE_ATOL,
             which the shards reassembled in reverse order must fail; (c)
             rows within MESH_POSE_ATOL (scores REFINE_SCORE_ATOL), slot map
             and LRU order the unsharded cached run's; (d) each object's
             binarised masks IoU >= MESH_SAM2_IOU_MIN on every frame of the
             unsharded predictor's at the shard's batch (each object
             alone), and the largest low-res logit difference within
             MESH_SAM2_LOGIT_ATOL of the unsharded predictor with both
             objects in one batch, each of which the shards' outputs
             swapped must fail; the IoUs against both objects in one batch,
             and that batch against the objects alone, are printed (bf16
             rounds otherwise at another object count, and random weights
             leave many logits near 0); (e) rows within BATCHED_POSE_ATOL of the unsharded
             batched path, inlier counts within 1 with the same best frame;
             (f) the CLIs' rows and proposals equal the unsharded CLIs'.
             With two cards or more, (a) and (b) again on a mesh over the
             real cards and K5 on cuda:1 against its plain version; with
             one, the line says that part was skipped. Prints the mesh,
             ms per refine and per SAM2 frame sharded and unsharded, launches
             per shard, peak memory and the phase's seconds; the work
             directory is deleted after it;
then the kernels JSON line, the card's name and power limit, and last the
device JSON line. Exits non-zero, printing no result, without a GPU or
without the rest of the repository beside it.
"""
from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12

# Attention kernel checks draw keys and values N(0, 1) and queries
# N(0, QUERY_STD²), so that with scale d^-0.5 the logits have std QUERY_STD
# and each row's softmax holds a few keys: outputs of O(1), and a kernel that
# dropped a key tile, a memory slot or the pointer tokens would move some
# output by O(1).
QUERY_STD = 3.0
# Attention kernels against their plain versions in bf16: elementwise within
# ops.attention.bf16_error_bound, 2^-7·(|ref| + Σ p|v| / l) (both round p and
# the output to bf16, against different maxima). In fp32 the same function
# summed in another order.
ATTN_TOL = "2^-7·(|ref| + softmax(q·kᵀ·scale)·|v|)"
K2_TOL_FP32 = dict(atol=1e-5, rtol=1e-5)
# K5 against its plain version: the same fp32 function summed in another
# order, |out - ref| <= atol + rtol·|ref| (K2's fp32 tolerance).
K5_TOL = dict(atol=1e-5, rtol=1e-5)
K5_SHAPE = (1, 16, 577, 64)  # ZoeD_N: 384² input, 24² patches + cls, 16 heads of 64
# K5's key-split counts, each checked and timed at K5_SHAPE: the
# measurements k5_config rests on.
K5_SPLITS = (1, 2, 3, 4)
# Scale path: one frame's ZoeD_N depth with K5 vs with every biased attention
# on the plain version. fp32 sums in another order in each of 24 blocks,
# carried through the DPT neck and the bins head: relative to the largest
# depth.
DEPTH_REL_TOL = 1e-4
PRIOR_NAMES = 2201  # the LLM scale prior's object names (the reference's data/*.json)
QUERY_K = 11
DROPPED_KEYS = 64  # keys a wrong kernel drops in the tolerance's own check
# The d 64 builds of the sm90 kernel, (warpgroups, key splits): 64-row blocks
# two per SM, and 192-row blocks one per SM.
SM90_D64_CONFIGS = ((1, 1), (3, 1))
# The d 72 builds (the same two block sizes) at the Hiera-L global shape, and
# K4's key-split counts at the memory cross-attention shape, each checked
# and timed: the measurements the warpgroup and split rules rest on.
SM90_D72_CONFIGS = ((1, 1), (2, 1), (3, 1), (3, 3))
K4_CONFIGS = ((2, 1), (2, 2), (2, 3), (2, 4), (2, 6), (2, 8))
# K4 on a batch element whose keys are all masked against the uniform mean
# of its V in fp32: p is exactly 1 for every key, so only the fp32 sum's
# order and the output's bf16 rounding (2^-8·|ref|) differ; a kernel that
# skips every tile of that element writes 0 and fails it.
UNIFORM_TOL = "2^-7·|ref| + 1e-5"
# The combine kernel against its plain version on the same fp32 partials:
# the same fp32 sums (in another order, with another exp) each rounded to
# bf16 once, so one bf16 step apart where they straddle a rounding boundary;
# one step is up to 2^-7·|ref|, and the tolerance allows two.
COMBINE_TOL = "2^-6·|ref| + 1e-6"
# K1 against its plain version: the same fp32 operations in the same order
# (kernel built without FMA contraction).
K1_ATOL = 1e-5
# The video path's SAM2 masks with every attention call on the kernels vs on
# the plain versions: the same bf16 arithmetic summed in another order, fed
# back through 10 frames of memory; logits compared at the low resolution.
VIDEO_IOU_MIN = 0.9
VIDEO_LOGIT_ATOL = 1.0  # low-res mask logits of O(10); bf16 steps there are 0.03-0.06
# The VOS path's own masks on frames 1-9, kernels vs plain attention: every
# object on every frame, and each object's J&F over the track.
VOS_IOU_FLOOR, VOS_JF_MIN = 0.8, 0.9

SEED = 0
RES, TILE, MFACES, CHUNK = 420, 28, 256, 128
N_VIEWS, BANK_BATCH, N_PROPOSALS = 600, 128, 4
DINO_LAYER = 22
# Video path: frames, frame size (H, W), objects, mesh bank rows (the
# Objaverse-LVIS + GSO bank) and feature width (DINOv2-L).
VIDEO_FRAMES, VIDEO_HW, VIDEO_OBJECTS, BANK_ROWS, BANK_DIM = 10, (720, 1280), 2, 46000, 1024
MIN_MASK_PX = 400  # the CLI's default
WORK_DIR = Path(__file__).resolve().parent / "freepose_tpu_torch" / "_build" / "smoke_video"


SM90_SOURCE = "freepose_tpu_torch/csrc/flash_attention_sm90.cu"
TILE_SOURCE = "freepose_tpu_torch/csrc/flash_attention.cu"


def log(phase: str, **fields) -> None:
    print(f"{phase}: {json.dumps(fields)}", flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device milliseconds per call over `reps` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int = 20) -> float:
    """Host milliseconds per call of `fn` over `reps` calls issued back to
    back: the wrapper's own time where the device keeps up with it."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs / reps * 1e3


def device_ms(fn, reps: int = 5) -> float | None:
    """Device ms per call of `fn`: the time of the kernels it launches,
    summed by torch.profiler over `reps` calls, without the host time
    between launches that CUDA events also see when the host is slower.
    The profiler now and then records no kernel at all: then it measures
    once more, and None (not measured) if it records none again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
        if total > 0:
            return total / 1e3 / reps
    return None


def reset_launches() -> None:
    """Count every kernel launch from 0: a new tracing session
    (utils/timing.py; `main` runs with tracing on)."""
    from freepose_tpu_torch.utils import timing

    timing.reset()


def read_launches() -> dict:
    """Every kernel wrapper's launch count (the `launch.<kernel>` counters),
    K2 also by head dim, and the attention launches by device program
    (`launches_by_kernel`: "sm90" the wgmma + TMA kernel, "f32" the fp32
    one); "key_tiles" counts K4's list kernel."""
    from freepose_tpu_torch.utils import timing

    def n(kernel: str) -> int:
        return timing.counts.get("launch." + kernel, 0)

    by_dim = {name[len("launch.k2.d"):]: c for name, c in timing.counts.items() if name.startswith("launch.k2.d")}
    return {"K1": n("k1"), "K2": n("k2"), "K3": n("k3"), "K4": n("k4"), "K5": n("k5"),
            "K5_combine": n("bias_combine"), "combine": n("attention_combine"), "key_tiles": n("key_tiles"),
            "K2_by_dim": {d: by_dim[d] for d in sorted(by_dim, key=int)},
            "launches_by_kernel": {kernel: n(kernel) for kernel in ("sm90", "f32")}}


def sam2_graph_counts(path: str, tracking_steps: int) -> dict:
    """SAM2's graph counters since reset_launches (models/sam2/video.py:
    _TrackGraph), checked: a graph key's first tracking step runs eagerly,
    its second captures and replays, every later one replays, so the
    replays are the `tracking_steps` less the capturing calls' eager ones
    (one a capture)."""
    from freepose_tpu_torch.utils import timing

    got = dict(captures=timing.counts.get("sam2.graph_captures", 0),
               replays=timing.counts.get("sam2.graph_replays", 0), tracking_steps=tracking_steps)
    if got["captures"] < 1 or got["replays"] != tracking_steps - got["captures"]:
        raise AssertionError(f"{path} path: SAM2's tracking steps did not replay as graphs: {got}")
    return got


def check_attention(out: torch.Tensor, ref: torch.Tensor, allowed: torch.Tensor, wrong: dict) -> dict:
    """Hold a kernel's bf16 output against its plain version `ref`,
    elementwise within `allowed` (bf16_error_bound), and show that the
    tolerance separates: each entry of `wrong` (the plain version of a kernel
    that drops keys) must break it. Returns the kernel's max abs error and
    each tolerance ratio, max |x - ref| / allowed (at most 1 to pass)."""
    def ratio(x):
        return float(((x.float() - ref.float()).abs() / allowed).max())

    res = {"max_abs_err": float((out.float() - ref.float()).abs().max()), "tol_ratio": ratio(out)}
    if res["tol_ratio"] > 1.0:
        raise AssertionError(f"kernel vs plain version beyond {ATTN_TOL}: {res}")
    for name, w in wrong.items():
        res[f"{name}_tol_ratio"] = r = ratio(w)
        if r <= 1.0:
            raise AssertionError(f"tolerance {ATTN_TOL} does not fail a kernel that {name}: ratio {r}")
    return res


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    """The least time in ms for `flops` operations at `peak_flops` (default:
    bf16 on the tensor cores) and `nbytes` moved at the card's peak rates,
    and which of the two bounds it."""
    bytes_ms, ops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, flops / peak_flops * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def k1_bound(rows: torch.Tensor, slots: torch.Tensor, res: int, tile: int, depth_only: bool) -> dict:
    """K1's bound on this run's data. Bytes: the slots read once, the rows
    the function uses (geometry, plus colour unless depth_only) of each
    distinct face the slots hold, and the image written once (depth alone
    when depth_only, else depth and colour). Operations: 21 per valid
    (pixel, face) pair, its coverage test: three edge functions (5 each),
    three sign products and three compares."""
    from freepose_tpu_torch.ops.rasterizer_cuda import _ROWS

    p, n_faces, _ = rows.shape
    held = slots >= 0
    idx = slots.clamp(min=0).reshape(p, -1).long()
    face_ok = rows[..., _ROWS["valid"]].gather(1, idx).reshape(slots.shape) > 0.5
    valid_pairs = int((held & face_ok).sum()) * tile * tile
    pose_of = torch.arange(p, device=slots.device).reshape(p, 1, 1).expand_as(slots)
    faces_held = int(torch.unique((pose_of * n_faces + slots)[held]).numel())
    row_floats = (_ROWS["valid"] if depth_only else _ROWS["c2b"]) + 1
    nbytes = faces_held * row_floats * 4 + slots.numel() * 4 + p * res * res * (1 if depth_only else 4) * 4
    bound_ms, bound_by = bound(21 * valid_pairs, nbytes, PEAK_FP32_FLOPS)
    return dict(bound_ms=bound_ms, bound_by=bound_by, bound_bytes=nbytes, valid_pairs=valid_pairs,
                faces_held=faces_held)


def torus_positions(rng, n_u: int, n_v: int) -> np.ndarray:
    """[n_u·n_v, 3] points of a torus whose minor radius is modulated by
    seeded harmonics (integer frequencies, so it closes at the seams)."""
    u = 2 * np.pi * np.arange(n_u) / n_u
    v = 2 * np.pi * np.arange(n_v) / n_v
    uu, vv = np.meshgrid(u, v, indexing="ij")
    bump = sum(rng.uniform(0.03, 0.08) * np.sin(a * uu + b * vv + rng.uniform(0, 2 * np.pi))
               for a, b in rng.integers(1, 6, size=(4, 2)))
    r = 0.35 * (1.0 + bump)
    return np.stack([(1.0 + r * np.cos(vv)) * np.cos(uu), (1.0 + r * np.cos(vv)) * np.sin(uu),
                     0.6 * r * np.sin(vv)], -1).reshape(-1, 3)


def bumpy_torus(seed: int = SEED, n_u: int = 128, n_v: int = 64):
    """Seeded coloured torus at exactly the renderer's budget: 8192
    vertices, 16384 faces, minor radius modulated by random harmonics."""
    from freepose_tpu_torch.io.mesh import TriMesh

    rng = np.random.default_rng(seed)
    verts = torus_positions(rng, n_u, n_v)
    i, j = np.meshgrid(np.arange(n_u), np.arange(n_v), indexing="ij")
    a, b = i * n_v + j, ((i + 1) % n_u) * n_v + j
    c, d = i * n_v + (j + 1) % n_v, ((i + 1) % n_u) * n_v + (j + 1) % n_v
    faces = np.concatenate([np.stack([a, b, c], -1), np.stack([b, d, c], -1)], 0).reshape(-1, 3)
    colors = np.clip(0.5 + 0.5 * np.sin(verts @ rng.normal(size=(3, 3)) * 3.0), 0, 1)
    return TriMesh(verts.astype(np.float32), faces.astype(np.int32),
                   colors.astype(np.float32)).normalized()


def random_dinov2_params(cfg, seed: int = SEED) -> dict:
    """Seeded random DINOv2 parameters in the JAX package's tree layout
    (Dense kernels [in, out], HWIO conv, blocks stacked [L, ...])."""
    rng = np.random.default_rng(seed)
    d, L, hid, p = cfg.hidden_size, cfg.num_layers, int(cfg.hidden_size * cfg.mlp_ratio), cfg.patch_size

    def dense(n_in, n_out):
        return {"kernel": rng.standard_normal((L, n_in, n_out), np.float32) / np.float32(math.sqrt(n_in)),
                "bias": np.zeros((L, n_out), np.float32)}

    def norm():
        return {"scale": np.ones((L, d), np.float32), "bias": np.zeros((L, d), np.float32)}

    gamma = {"gamma": np.full((L, d), 0.1, np.float32)}
    return {
        "patch_embed": {"kernel": rng.standard_normal((p, p, 3, d), np.float32) / np.float32(p * math.sqrt(3)),
                        "bias": np.zeros((d,), np.float32)},
        "cls_token": rng.standard_normal((1, 1, d), np.float32) * np.float32(0.02),
        "reg_tokens": rng.standard_normal((1, cfg.num_registers, d), np.float32) * np.float32(0.02),
        "pos_embed": rng.standard_normal((1, 1 + cfg.native_grid ** 2, d), np.float32) * np.float32(0.02),
        "norm": {"scale": np.ones((d,), np.float32), "bias": np.zeros((d,), np.float32)},
        "blocks": {"block": {
            "norm1": norm(), "norm2": norm(), "ls1": gamma, "ls2": dict(gamma),
            "attn": {"qkv": dense(d, 3 * d), "proj": dense(d, d)},
            "mlp": {"fc1": dense(d, hid), "fc2": dense(hid, d)},
        }},
    }


def phase_build() -> None:
    from freepose_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    logs = cuda_build.build(["raster_tile", "flash_attention", "flash_attention_sm90"])
    secs = time.perf_counter() - t0
    keep = ("registers", "spill", "entry", "serialized", "setmaxnreg", "warning")
    ptxas = {name: [ln.strip() for ln in out.splitlines() if any(w in ln for w in keep)]
             for name, out in logs.items()}
    log("build", seconds=secs, ptxas=ptxas)


def reads_next_head(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, key_tile: int,
                    kv_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain stand-in of a wrong kernel that loads K and V through a 2-D map
    [bh·nk, d] and leaves the keys past nk unmasked: each head's ragged last
    key tile holds the next head's first rows (zeros after the last head),
    which a key mask [B, nk], if any, leaves valid."""
    from freepose_tpu_torch.ops.attention import dense_attention_masked

    b, h, nk, d = k.shape
    pad = -nk % key_tile
    rows = torch.arange(b * h, device=k.device)[:, None] * nk + torch.arange(nk + pad, device=k.device)[None]

    def window(x):
        flat = torch.cat([x.reshape(b * h * nk, d), x.new_zeros((pad, d))])
        return flat[rows].reshape(b, h, nk + pad, d)

    if kv_mask is not None:
        kv_mask = torch.cat([kv_mask, kv_mask.new_ones((b, pad))], dim=1)
    return dense_attention_masked(q, window(k), window(v), scale, kv_mask)


def drops_partial_tiles(kv_mask: torch.Tensor, key_tile: int) -> torch.Tensor:
    """The key mask a wrong K4 would apply if it skipped every partially
    masked key tile as empty: kv_mask with every key of those tiles masked
    (the tiles `key_tile_list` flags)."""
    from freepose_tpu_torch.ops.attention import key_tile_list

    _, order, flags = key_tile_list(kv_mask, key_tile)
    b, nk = kv_mask.shape
    tiles = order.shape[1]
    partial = torch.zeros((b, tiles + 1), dtype=torch.bool, device=kv_mask.device)
    partial.scatter_(1, torch.where(flags.bool(), order.long(), tiles), True)  # unflagged -> the spare column
    return kv_mask & ~partial[:, :tiles].repeat_interleave(key_tile, dim=1)[:, :nk]


def in_turns(new, prev, reps: int) -> tuple[float, float]:
    """Device ms of two versions on the same inputs, timed in turns new,
    prev, prev, new; each the mean of its two runs."""
    a, b, c, d = cuda_ms(new, reps), cuda_ms(prev, reps), cuda_ms(prev, reps), cuda_ms(new, reps)
    return (a + d) / 2, (b + c) / 2


def phase_k2(dev) -> dict:
    import torch.nn.functional as F

    from freepose_tpu_torch.ops.attention import (bf16_error_bound, dense_attention, flash_attention_sm90,
                                                  sm90_config, sm90_key_tile)
    from freepose_tpu_torch.ops.attention import flash_attention_k2 as flash_attention

    gen = torch.Generator(device=dev).manual_seed(SEED)
    scale = 64 ** -0.5
    heads, n, d = 16, 1 + 4 + (RES // 14) ** 2, 64
    key_tile = sm90_key_tile(d)

    def qkv(b, length, dtype):
        q, k, v = (torch.randn((b, heads, length, d), generator=gen, device=dev) for _ in range(3))
        return (q * QUERY_STD).to(dtype), k.to(dtype), v.to(dtype)

    # The batches of 420² crops the paths give K2: the template pack's ViT
    # batches, a static frame's proposals, and the 1-2 tracked masks of a
    # video frame's retrieval; then a ragged length and fp32.
    checks = {}
    for label, b, length, dtype in (("bank", BANK_BATCH, n, torch.bfloat16),
                                    ("b8", 8, n, torch.bfloat16),
                                    ("frame", N_PROPOSALS, n, torch.bfloat16),
                                    ("crop2", 2, n, torch.bfloat16),
                                    ("crop1", 1, n, torch.bfloat16),
                                    ("ragged", 8, 37, torch.bfloat16),
                                    ("fp32", 2, 130, torch.float32)):
        q, k, v = qkv(b, length, dtype)
        out = flash_attention(q, k, v, scale)
        ref = dense_attention(q, k, v, scale)
        torch.cuda.synchronize()
        if dtype == torch.float32:
            torch.testing.assert_close(out, ref, **K2_TOL_FP32)
            checks[label] = {"max_abs_err": float((out - ref).abs().max())}
            continue
        # Every n here is ragged against the key tile.
        wrong = {"reads_next_head": reads_next_head(q, k, v, scale, key_tile)}
        if label != "ragged":
            wrong["drops_last_keys"] = dense_attention(q, k[:, :, :-DROPPED_KEYS], v[:, :, :-DROPPED_KEYS], scale)
        allowed = bf16_error_bound(q, k, v, scale, ref)
        c = checks[label] = check_attention(out, ref, allowed, wrong)
        c["warpgroups_splits"] = picked = sm90_config(b * heads, length, length, d, key_tile)
        del wrong, out
        if label != "ragged":
            # Each d 64 build of the kernel at this shape: held to the same
            # bound, and its device time beside SDPA's.
            c["configs"] = {}
            for config in SM90_D64_CONFIGS:
                def run(config=config):
                    return flash_attention_sm90(q, k, v, scale, config)

                c["configs"][f"{config[0]}wg"] = {"tol_ratio": check_attention(run(), ref, allowed, {})["tol_ratio"],
                                                  "device_ms": device_ms(run)}
            c["device"] = {"ms": c["configs"][f"{picked[0]}wg"]["device_ms"],
                           "sdpa_ms": device_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))}
            if label != "bank":  # the bank shape is timed below, for the kernels line
                c["ms"] = cuda_ms(lambda: flash_attention(q, k, v, scale), reps=20)
                # Where CUDA events exceed the device times, the host's.
                c["host_ms"] = {"ms": host_ms(lambda: flash_attention(q, k, v, scale)),
                                "sdpa_ms": host_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))}
        if label == "bank":
            main = (q, k, v)
        del ref, allowed
    q, k, v = main
    ms = cuda_ms(lambda: flash_attention(q, k, v, scale), reps=20)
    plain_ms = cuda_ms(lambda: dense_attention(q, k, v, scale), reps=3)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), reps=10)
    bh = BANK_BATCH * heads
    flops = 4 * bh * n * n * d
    bound_ms, bound_by = bound(flops, 4 * bh * n * d * q.element_size())
    rec = dict(name="K2 flash_attention_k2 (whole-K/V attention), d 64", route="cuda", source=SM90_SOURCE,
               replaces="freepose_tpu/ops/attention.py:75", max_abs_err=checks["bank"]["max_abs_err"],
               ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    log("k2", shape=[BANK_BATCH, heads, n, d], dtype="bf16", checks=checks, tol=ATTN_TOL, tol_fp32=K2_TOL_FP32,
        ms=ms, plain_ms=plain_ms, sdpa_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
        tflops=flops / ms / 1e9, device=checks["bank"]["device"])
    del q, k, v, main
    torch.cuda.empty_cache()
    return rec


def check_combine(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> tuple[dict, dict]:
    """The combine kernel against its plain version on the same fp32
    partials: the plain (m, l, acc) of the key ranges the sm90 kernel splits
    this shape into. The tolerance must fail a combine that drops the first
    split. Returns (check, record for the kernels line)."""
    from freepose_tpu_torch.ops.attention import (attention_combine, attention_partials, combine_partials,
                                                  sm90_config, sm90_key_tile)

    b, h, n, d = q.shape
    nk, key_tile = k.shape[2], sm90_key_tile(d)
    tiles = -(-nk // key_tile)
    per = -(-tiles // sm90_config(b * h, n, nk, d, key_tile)[1]) * key_tile
    parts = [attention_partials(q, k[:, :, a:a + per], v[:, :, a:a + per], scale) for a in range(0, nk, per)]
    m, l, acc = (torch.stack(x) for x in zip(*parts))
    out, ref = attention_combine(m, l, acc), combine_partials(m, l, acc)
    torch.cuda.synchronize()
    allowed = 2.0 ** -6 * ref.float().abs() + 1e-6

    def ratio(x):
        return float(((x.float() - ref.float()).abs() / allowed).max())

    check = {"splits": len(parts), "max_abs_err": float((out.float() - ref.float()).abs().max()),
             "tol_ratio": ratio(out), "drops_a_split_tol_ratio": ratio(combine_partials(m[1:], l[1:], acc[1:]))}
    if check["tol_ratio"] > 1.0 or check["drops_a_split_tol_ratio"] <= 1.0:
        raise AssertionError(f"combine kernel vs plain version, tolerance {COMBINE_TOL}: {check}")
    ms = cuda_ms(lambda: attention_combine(m, l, acc), reps=20)
    plain_ms = cuda_ms(lambda: combine_partials(m, l, acc), reps=5)
    # Each partial read once and the bf16 output written once; a multiply-add
    # per partial element.
    bound_ms, bound_by = bound(2.0 * acc.numel(), 4 * (acc.numel() + m.numel() + l.numel()) + 2 * out.numel(),
                               PEAK_FP32_FLOPS)
    rec = dict(name="attention_combine (merge of the sm90 kernel's key splits)", route="cuda", source=SM90_SOURCE,
               replaces="freepose_tpu/ops/attention.py:66", max_abs_err=check["max_abs_err"], ms=ms,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    check.update(tol=COMBINE_TOL, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    return check, rec


def check_k4_extra(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, mask: torch.Tensor,
                   randn) -> tuple[dict, dict]:
    """K4's own checks beyond the smoke mask's: ragged mask runs with a
    ragged nk (against stand-ins that read the next head's rows or skip
    partially masked tiles), a batch element with every key masked (against
    one that writes 0 for it), the list kernel against key_tile_list at the
    smoke's, the ragged and the all-masked mask (identical), and the tiles
    the smoke mask leaves. Returns (checks, record of the list kernel for the
    kernels line)."""
    from freepose_tpu_torch.ops.attention import (bf16_error_bound, dense_attention_masked, flash_attention_stream,
                                                  key_tile_list, key_tiles, sm90_key_tile)

    b, h, n, d = q.shape
    nk, key_tile = k.shape[2], sm90_key_tile(d)
    checks = {}
    # Ragged runs: valid keys that start and end inside key tiles (at 28,736
    # keys: from 37, 4,109, 9,580 and 19,157 on, a hole at 25,144), nk - 27
    # keys.
    rnk = nk - 27
    rmask = torch.zeros((b, rnk), dtype=torch.bool, device=q.device)
    for e in range(b):
        for a, z in ((37 + 5 * e, nk // 7 + 4), (nk // 3 + 2, nk // 3 + 4), (2 * nk // 3 + 13 * e, rnk - 5)):
            rmask[e, a:z] = True
        rmask[e, 7 * nk // 8:7 * nk // 8 + 50] = False
    rk, rv = randn(b, h, rnk, d), randn(b, h, rnk, d)
    rref = dense_attention_masked(q, rk, rv, scale, rmask)
    checks["ragged_runs"] = check_attention(
        flash_attention_stream(q, rk, rv, scale, kv_mask=rmask), rref, bf16_error_bound(q, rk, rv, scale, rref, rmask),
        {"reads_next_head": reads_next_head(q, rk, rv, scale, key_tile, rmask),
         "drops_partial_tiles": dense_attention_masked(q, rk, rv, scale, drops_partial_tiles(rmask, key_tile))})
    checks["ragged_runs"]["partial_tiles"] = int(key_tile_list(rmask, key_tile)[2].sum())
    del rk, rv, rref
    # Batch element 1 with every key masked: the uniform mean of its V.
    amask = mask.clone()
    amask[1] = False
    out = flash_attention_stream(q, k, v, scale, kv_mask=amask)
    ref0 = dense_attention_masked(q[:1], k[:1], v[:1], scale, amask[:1])
    uniform = v[1].float().mean(dim=1, keepdim=True).expand(-1, n, -1)
    allowed = 2.0 ** -7 * uniform.abs() + 1e-5

    def ratio(x):
        return float(((x.float() - uniform).abs() / allowed).max())

    am = checks["all_masked"] = {"other_element": check_attention(out[:1], ref0, bf16_error_bound(
        q[:1], k[:1], v[:1], scale, ref0, amask[:1]), {}), "max_abs_err": float((out[1].float() - uniform).abs().max()),
        "tol_ratio": ratio(out[1]), "zeroed_tol_ratio": ratio(torch.zeros_like(uniform)), "tol": UNIFORM_TOL}
    if am["tol_ratio"] > 1.0 or am["zeroed_tol_ratio"] <= 1.0:
        raise AssertionError(f"K4 on an all-masked batch element vs the uniform mean, tolerance {UNIFORM_TOL}: {am}")
    del out, ref0, uniform, allowed
    # The list kernel against its plain version, at each mask.
    lists = {}
    for name, m in (("smoke", mask), ("ragged_runs", rmask), ("all_masked", amask)):
        ours, plain = key_tiles(m, key_tile), key_tile_list(m, key_tile)
        same = all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(ours, plain))
        lists[name] = {"identical": same, "listed": ours[0].tolist(), "flagged": int(ours[2].sum())}
        if not same:
            raise AssertionError(f"list kernel vs key_tile_list at the {name} mask: {ours} vs {plain}")
    checks["key_tiles"] = lists
    tiles = -(-nk // key_tile)
    checks["valid_tiles"] = {"processed": sum(lists["smoke"]["listed"]), "of": b * tiles}
    ms = cuda_ms(lambda: key_tiles(mask, key_tile), reps=20)
    plain_ms = cuda_ms(lambda: key_tile_list(mask, key_tile), reps=5)
    # The mask read once, the count, list and flags written once; one
    # comparison per mask byte.
    bound_ms, bound_by = bound(float(mask.numel()), mask.numel() + 4 * b + 5 * b * tiles, PEAK_FP32_FLOPS)
    checks["key_tiles"].update(ms=ms, device_ms=device_ms(lambda: key_tiles(mask, key_tile)), plain_ms=plain_ms,
                               bound_ms=bound_ms)
    rec = dict(name="key_tiles (K4's list of key tiles holding a valid key)", route="cuda", source=SM90_SOURCE,
               replaces="freepose_tpu/ops/attention.py:250", max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    return checks, rec


def phase_stream_kernels(dev) -> dict:
    """K2 at the video path's head dims, K3 and K4, each against its plain
    version and timed beside it and beside SDPA, with the warpgroup and
    split configurations the rules choose from; each on a ragged key count
    against a kernel that reads the next head's rows; K3's combine and K4's
    list kernel against their plain versions. Returns {kernel: record}."""
    import torch.nn.functional as F

    from freepose_tpu_torch.ops.attention import (bf16_error_bound, dense_attention, dense_attention_masked,
                                                  flash_attention_k2, flash_attention_k3, flash_attention_sm90,
                                                  flash_attention_stream, sm90_config, sm90_key_tile)

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(torch.bfloat16)

    # Memory cross-attention keys: 7 mask-memory slots of 64² tokens, then 16
    # object pointers of 4 tokens. Object 0 has every slot and pointer;
    # object 1 only its conditioning slot, slot 1 and 3 pointers, so whole
    # slots (whole key tiles) are masked.
    hw, n_slots, n_ptr_tok = 4096, 7, 16 * 4
    nk_mem = n_slots * hw + n_ptr_tok
    mask = torch.ones((2, nk_mem), dtype=torch.bool, device=dev)
    mask[1, 2 * hw:n_slots * hw] = False
    mask[1, n_slots * hw + 3 * 4:] = False
    # What a wrong K4 could drop: every object pointer, or object 0's slot 1.
    no_pointers, no_slot = mask.clone(), mask.clone()
    no_pointers[:, n_slots * hw:] = False
    no_slot[0, hw:2 * hw] = False
    cases = {
        # Hiera's global blocks as the video predictor runs them: one trunk
        # call over a propagation batch of COUPLED_CHUNK frames.
        "K2_d72": dict(q=(COUPLED_CHUNK, 8, hw, 72), nk=hw, kernel=flash_attention_k2, mask=None,
                       configs=SM90_D72_CONFIGS,
                       name="K2 flash_attention_k2 (whole-K/V attention), d 72",
                       replaces="freepose_tpu/ops/attention.py:75"),
        "K2_d256": dict(q=(2, 1, hw, 256), nk=hw, kernel=flash_attention_k2, mask=None, configs=(),
                        name="K2 flash_attention_k2 (whole-K/V attention), d 256",
                        replaces="freepose_tpu/ops/attention.py:75"),
        "K3": dict(q=(1, 1, hw, 256), nk=6144, kernel=flash_attention_k3, mask=None, configs=(),
                   name="K3 flash_attention_k3 (streaming attention, no mask)",
                   replaces="freepose_tpu/ops/attention.py:30"),
        "K4": dict(q=(2, 1, hw, 256), nk=nk_mem, kernel=flash_attention_stream, mask=mask, configs=K4_CONFIGS,
                   name="K4 flash_attention_stream (streaming attention, per-batch key mask)",
                   replaces="freepose_tpu/ops/attention.py:208"),
    }
    recs = {}
    for label, c in cases.items():
        b, h, n, d = c["q"]
        q, k, v = randn(b, h, n, d, std=QUERY_STD), randn(b, h, c["nk"], d), randn(b, h, c["nk"], d)
        scale = d ** -0.5
        m = c["mask"]
        key_tile = sm90_key_tile(d)
        if m is None:
            def run():
                return c["kernel"](q, k, v, scale)

            def plain():
                return dense_attention(q, k, v, scale)

            def library():
                return F.scaled_dot_product_attention(q, k, v, scale=scale)
        else:
            def run():
                return c["kernel"](q, k, v, scale, kv_mask=m)

            def plain():
                return dense_attention_masked(q, k, v, scale, m)

            sdpa_mask = m[:, None, None, :]

            def library():
                return F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask, scale=scale)
        out, ref = run(), plain()
        torch.cuda.synchronize()
        if m is None:
            wrong = {"drops_last_keys": dense_attention(q, k[:, :, :-DROPPED_KEYS], v[:, :, :-DROPPED_KEYS], scale)}
        else:
            wrong = {"drops_pointers": dense_attention_masked(q, k, v, scale, no_pointers),
                     "drops_a_slot": dense_attention_masked(q, k, v, scale, no_slot)}
        allowed = bf16_error_bound(q, k, v, scale, ref, m)
        check = check_attention(out, ref, allowed, wrong)
        err = check["max_abs_err"]
        extra = {}
        extra["warpgroups"], extra["splits"] = sm90_config(b * h, n, c["nk"], d, key_tile, masked=m is not None)
        if c["configs"]:
            # Each configuration the rules choose from, held to the same bound
            # and timed on the device.
            extra["configs"] = {}
            for config in c["configs"]:
                def forced(config=config):
                    return flash_attention_sm90(q, k, v, scale, config, kv_mask=m)

                extra["configs"][f"{config[0]}wg_{config[1]}split"] = {
                    "tol_ratio": check_attention(forced(), ref, allowed, {})["tol_ratio"],
                    "device_ms": device_ms(forced)}
        del out, ref, wrong, allowed
        ms = cuda_ms(run, reps=20)
        extra["device"] = {"ms": device_ms(run), "sdpa_ms": device_ms(library)}
        if m is None:
            # A ragged key count over two heads: the tolerance fails a kernel
            # that fills the ragged tile with the next head's rows.
            rq, rk, rv = randn(2, h, n, d, std=QUERY_STD), randn(2, h, c["nk"] - 27, d), randn(2, h, c["nk"] - 27, d)
            rref = dense_attention(rq, rk, rv, scale)
            check["ragged_keys"] = check_attention(
                c["kernel"](rq, rk, rv, scale), rref, bf16_error_bound(rq, rk, rv, scale, rref),
                {"reads_next_head": reads_next_head(rq, rk, rv, scale, key_tile)})
            del rq, rk, rv, rref
        else:
            k4_checks, recs["key_tiles"] = check_k4_extra(q, k, v, scale, m, randn)
            check.update(k4_checks)
        plain_ms = cuda_ms(plain, reps=2)
        library_ms = cuda_ms(library, reps=10)
        if label == "K3":  # the other regime on the same inputs: what flash_attention's dispatch weighs
            extra["k2_ms_same_inputs"] = cuda_ms(lambda: flash_attention_k2(q, k, v, scale), reps=10)
            extra["combine"], recs["combine"] = check_combine(q, k, v, scale)
        # Work these inputs need: the products over every valid key, each
        # input and the output moved once.
        valid_keys = h * (int(m.sum()) if m is not None else b * c["nk"])
        flops = 4.0 * n * d * valid_keys
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel()) + (m.numel() if m is not None else 0)
        bound_ms, bound_by = bound(flops, nbytes)
        recs[label] = dict(name=c["name"], route="cuda", source=SM90_SOURCE, replaces=c["replaces"],
                           max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                           library_ms=library_ms)
        log(label.lower(), q=list(c["q"]), nk=c["nk"], masked_keys=int((~m).sum()) if m is not None else 0,
            dtype="bf16", source=SM90_SOURCE, check=check, tol=ATTN_TOL, ms=ms, plain_ms=plain_ms,
            sdpa_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by, tflops=flops / ms / 1e9, **extra)
        del q, k, v
        torch.cuda.empty_cache()
    return recs


def check_bias_combine(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, bias: torch.Tensor,
                       splits: int) -> tuple[dict, dict]:
    """K5's combine kernel against its plain version (`combine_partials` in
    fp32) on the same fp32 partials: the plain (m, l, acc) of the key shares
    K5 splits this shape into, with the bias. K5_TOL; the tolerance must fail
    a combine that drops the first split. Returns (check, record)."""
    from freepose_tpu_torch.ops.attention import K5_KEY_TILE, attention_partials, bias_combine, combine_partials

    nk = k.shape[2]
    per = -(-(-(-nk // K5_KEY_TILE)) // splits) * K5_KEY_TILE
    parts = [attention_partials(q, k[:, :, a:a + per], v[:, :, a:a + per], scale, None, bias[..., a:a + per])
             for a in range(0, nk, per)]
    m, l, acc = (torch.stack(x).contiguous() for x in zip(*parts))
    out, ref = bias_combine(m, l, acc), combine_partials(m, l, acc, torch.float32)
    torch.cuda.synchronize()

    def ratio(x):
        return float(((x - ref).abs() / (K5_TOL["atol"] + K5_TOL["rtol"] * ref.abs())).max())

    check = {"splits": len(parts), "max_abs_err": float((out - ref).abs().max()), "tol_ratio": ratio(out),
             "drops_a_split_tol_ratio": ratio(combine_partials(m[1:], l[1:], acc[1:], torch.float32))}
    if check["tol_ratio"] > 1.0 or check["drops_a_split_tol_ratio"] <= 1.0:
        raise AssertionError(f"K5's combine kernel vs plain version, tolerance {K5_TOL}: {check}")
    ms = cuda_ms(lambda: bias_combine(m, l, acc), reps=50)
    plain_ms = cuda_ms(lambda: combine_partials(m, l, acc, torch.float32), reps=10)
    device = device_ms(lambda: bias_combine(m, l, acc), reps=20)
    # Each partial read once and the fp32 output written once; a multiply-add
    # per partial element.
    bound_ms, bound_by = bound(2.0 * acc.numel(), 4 * (acc.numel() + m.numel() + l.numel() + out.numel()),
                               PEAK_FP32_FLOPS)
    rec = dict(name="bias_combine (merge of K5's key splits)", route="cuda", source=TILE_SOURCE,
               replaces="freepose_tpu/ops/attention.py:355", max_abs_err=check["max_abs_err"], ms=ms,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    check.update(tol=K5_TOL, ms=ms, device=device, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    return check, rec


def phase_k5(dev) -> tuple[dict, dict]:
    """K5 against its plain version at the ZoeD_N shape, batch 1 and 2 (the
    bias read at bh % heads), with and without a key mask, at the
    split count `k5_config` picks; the tolerance must fail the plain
    version without the bias and with the next head's. Each key-split
    count (K5_SPLITS) checked and timed at the main path's
    [1, 16, 577, 64] (`configs`); kernel, plain and SDPA times there; K5's
    combine kernel against its plain version (`check_bias_combine`).
    Returns the records of K5 and of its combine."""
    import torch.nn.functional as F

    from freepose_tpu_torch.ops.attention import (K5_ROWS, _num_sms, dense_attention_bias, flash_attention_bias,
                                                  k5_config)

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    h, n, d = K5_SHAPE[1:]
    scale = d ** -0.5
    bias = torch.randn((h, n, n), generator=gen, device=dev)
    picked = k5_config(K5_SHAPE[0] * h, n, n, _num_sms(dev))

    def ratio(x, ref):  # error over the allowed error; at most 1 to pass
        return float(((x - ref).abs() / (K5_TOL["atol"] + K5_TOL["rtol"] * ref.abs())).max())

    checks, main = {}, None
    for b in (1, 2):
        q = torch.randn((b, h, n, d), generator=gen, device=dev) * QUERY_STD
        k, v = (torch.randn((b, h, n, d), generator=gen, device=dev) for _ in range(2))
        mask = torch.ones((b, n), dtype=torch.bool, device=dev)
        mask[0, 100:181] = False
        mask[b - 1, 300:413] = False
        for m in (None, mask):
            label = f"b{b}" + ("_masked" if m is not None else "")
            out = flash_attention_bias(q, k, v, scale, bias, kv_mask=m)
            ref = dense_attention_bias(q, k, v, scale, bias, m)
            torch.cuda.synchronize()
            res = {"max_abs_err": float((out - ref).abs().max()), "tol_ratio": ratio(out, ref),
                   "splits": k5_config(b * h, n, n, _num_sms(dev))}
            for name, wrong in (("no_bias", None), ("next_head_bias", bias.roll(1, dims=0))):
                res[f"{name}_tol_ratio"] = ratio(dense_attention_bias(q, k, v, scale, wrong, m), ref)
            checks[label] = res
            if res["tol_ratio"] > 1.0:
                raise AssertionError(f"K5 vs plain version beyond {K5_TOL}: {label} {res}")
            if min(res["no_bias_tol_ratio"], res["next_head_bias_tol_ratio"]) <= 1.0:
                raise AssertionError(f"K5 tolerance {K5_TOL} does not fail a wrong bias: {label} {res}")
        if b == K5_SHAPE[0]:
            main = (q, k, v, mask)
    q, k, v, mask = main
    ref = dense_attention_bias(q, k, v, scale, bias)
    ref_masked = dense_attention_bias(q, k, v, scale, bias, mask)
    configs = {}
    for splits in K5_SPLITS:  # each split count, checked, then timed in turns with the rule's pick
        out = flash_attention_bias(q, k, v, scale, bias, splits=splits)
        out_masked = flash_attention_bias(q, k, v, scale, bias, kv_mask=mask, splits=splits)
        torch.cuda.synchronize()
        rec = {"tol_ratio": max(ratio(out, ref), ratio(out_masked, ref_masked))}
        if rec["tol_ratio"] > 1.0:
            raise AssertionError(f"K5 at {splits} splits vs plain version beyond {K5_TOL}: {rec}")
        rec["ms"], rec["picked_ms"] = in_turns(lambda s=splits: flash_attention_bias(q, k, v, scale, bias, splits=s),
                                               lambda: flash_attention_bias(q, k, v, scale, bias), reps=50)
        rec["device"] = device_ms(lambda s=splits: flash_attention_bias(q, k, v, scale, bias, splits=s), reps=20)
        configs[f"{splits}split"] = rec
    combine, combine_rec = check_bias_combine(q, k, v, scale, bias, max(2, picked))
    ms = cuda_ms(lambda: flash_attention_bias(q, k, v, scale, bias), reps=50)
    plain_ms = cuda_ms(lambda: dense_attention_bias(q, k, v, scale, bias), reps=10)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=bias[None], scale=scale)

    library_ms = cuda_ms(sdpa, reps=50)
    device = {"kernel": device_ms(lambda: flash_attention_bias(q, k, v, scale, bias), reps=20),
              "sdpa": device_ms(sdpa, reps=20)}
    flops = 4.0 * q.shape[0] * h * n * n * d
    nbytes = 4 * (4 * q.numel() + bias.numel())  # q, k, v and o, and the bias, once each, fp32
    bound_ms, bound_by = bound(flops, nbytes, PEAK_FP32_FLOPS)
    rec = dict(name="K5 flash_attention_bias (fp32 attention with a per-head logit bias)", route="cuda",
               source=TILE_SOURCE, replaces="freepose_tpu/ops/attention.py:317",
               max_abs_err=checks["b1"]["max_abs_err"], ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=library_ms)
    log("k5", shape=list(K5_SHAPE), bias=[h, n, n], dtype="fp32", rows=K5_ROWS, splits=picked, checks=checks,
        tol=K5_TOL, configs=configs, combine=combine, ms=ms, device=device, plain_ms=plain_ms, sdpa_ms=library_ms,
        bound_ms=bound_ms, bound_by=bound_by, bound_share=bound_ms / device["kernel"] if device["kernel"] else None,
        tflops=flops / ms / 1e9)
    del q, k, v, bias, main
    torch.cuda.empty_cache()
    return rec, combine_rec


def reads_next_pose(rows: torch.Tensor, slots: torch.Tensor, res: int, tile: int, ambient: float,
                    depth_only: bool) -> torch.Tensor:
    """Plain stand-in of a wrong K1 that gathers each tile's first slot from
    the next pose's face rows (a pose stride off by one for that slot)."""
    from freepose_tpu_torch.ops.rasterizer_cuda import raster_tile_plain

    f = rows.shape[1]
    both = torch.cat([rows, rows.roll(-1, dims=0)], dim=1)  # [P, 2F, 32]: this pose's rows, then the next's
    wrong = slots.clone()
    wrong[..., 0] = torch.where(slots[..., 0] >= 0, slots[..., 0] + f, slots[..., 0])
    return raster_tile_plain(both, wrong, res, tile, ambient, depth_only)


def phase_k1(dev, mesh) -> dict:
    """K1 on one 128-pose chunk at 420² against its plain version, colour
    and depth_only; the gate must fail a kernel that gathers a slot from the
    next pose's rows. The prologue timed by part: projection, binning
    (select_tile_faces) and face rows."""
    from freepose_tpu_torch.io.mesh import pad_mesh
    from freepose_tpu_torch.ops.rasterizer import RasterSettings
    from freepose_tpu_torch.ops.rasterizer_cuda import (N_ATTRS, bin_faces, face_rows, project_faces,
                                                         raster_tile, raster_tile_plain, rasterize_cuda)
    from freepose_tpu_torch.pipeline.renderer import RENDERING_SCALE, TemplateRenderer

    renderer = TemplateRenderer(n_poses=N_VIEWS, resolution=RES, device=dev)
    settings = RasterSettings(resolution=RES, tile=TILE, max_faces_per_tile=MFACES)
    padded = pad_mesh(mesh, renderer.max_vertices, renderer.max_faces)
    v, c, f, valid = (torch.as_tensor(a, device=dev) for a in padded)
    v = v * RENDERING_SCALE
    poses = renderer.poses[:CHUNK]
    ks = renderer.k.expand(poses.shape[0], 3, 3)

    tri_uv, tri_z, fvalid = project_faces(v, f, valid, poses, ks, settings)
    prologue_ms = {"projection": cuda_ms(lambda: project_faces(v, f, valid, poses, ks, settings), reps=5),
                   "binning": cuda_ms(lambda: bin_faces(tri_uv, fvalid, settings), reps=5),
                   "face_rows": cuda_ms(lambda: face_rows(tri_uv, tri_z, c, f, settings), reps=5)}
    rows, slots = face_rows(tri_uv, tri_z, c, f, settings), bin_faces(tri_uv, fvalid, settings)
    del tri_uv, tri_z, fvalid

    def check(out, ref):
        return (int(((out[..., 0] > 0) != (ref[..., 0] > 0)).sum()), float((out[..., 0] - ref[..., 0]).abs().max()),
                float((out[..., 1:] - ref[..., 1:]).abs().max()))

    refs = {do: raster_tile_plain(rows, slots, RES, TILE, settings.ambient, do) for do in (False, True)}
    out = raster_tile(rows, slots, RES, TILE, settings.ambient, False)
    mismatch, depth_err, rgb_err = check(out, refs[False])
    dmismatch, depth_only_err, _ = check(raster_tile(rows, slots, RES, TILE, settings.ambient, True), refs[True])
    hit_px = int((out[..., 0] > 0).sum())
    if mismatch or dmismatch or max(depth_err, rgb_err, depth_only_err) > K1_ATOL or hit_px == 0:
        raise AssertionError(f"K1 disagrees with its plain version: {mismatch} + {dmismatch} hit-mask mismatches, "
                             f"depth {depth_err}, rgb {rgb_err}, depth_only {depth_only_err}, hits {hit_px}")
    wrong = check(reads_next_pose(rows, slots, RES, TILE, settings.ambient, False), refs[False])
    if not (wrong[0] > 0 or max(wrong[1:]) > K1_ATOL):
        raise AssertionError(f"K1's gate does not fail a kernel that reads the next pose's rows: {wrong}")
    ms = cuda_ms(lambda: raster_tile(rows, slots, RES, TILE, settings.ambient, False), reps=10)
    device = device_ms(lambda: raster_tile(rows, slots, RES, TILE, settings.ambient, False), reps=5)
    chunk_ms = cuda_ms(lambda: rasterize_cuda(v, c, f, valid, poses, renderer.k, settings), reps=5)
    plain_ms = cuda_ms(lambda: raster_tile_plain(rows, slots, RES, TILE, settings.ambient, False), reps=1)
    p, n_faces, _ = rows.shape
    m = slots.shape[2]
    kb = k1_bound(rows, slots, RES, TILE, False)
    bound_ms, bound_by = kb["bound_ms"], kb["bound_by"]
    rec = dict(name="K1 raster_tile (tile rasterizer)", route="cuda",
               source="freepose_tpu_torch/csrc/raster_tile.cu",
               replaces="freepose_tpu/ops/rasterizer_pallas.py:44", max_abs_err=max(depth_err, rgb_err),
               ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    log("k1", poses=p, tiles=p * slots.shape[1], faces=n_faces, faces_per_tile=m, row_width=N_ATTRS,
        hit_px=hit_px, hit_mask_mismatches=mismatch, depth_max_err=depth_err,
        rgb_max_err=rgb_err, depth_only_max_err=depth_only_err, atol=K1_ATOL,
        reads_next_pose={"hit_mask_mismatches": wrong[0], "depth_max_err": wrong[1], "rgb_max_err": wrong[2]},
        prologue_ms=prologue_ms, prologue_total_ms=sum(prologue_ms.values()), ms=ms, device=device,
        chunk_ms=chunk_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        bound_share=bound_ms / device if device else None, valid_pairs=kb["valid_pairs"],
        faces_held=kb["faces_held"], bound_bytes=kb["bound_bytes"], input_mb={"face_rows": rows.numel() * 4 / 1e6, "slots": slots.numel() * 4 / 1e6})
    del rows, slots, out, refs
    torch.cuda.empty_cache()
    return rec


def profile_device_time(fn, label: str, top: int = 8) -> dict:
    """Device time by kernel over one call of `fn` (torch.profiler), the
    call's wall time, and the share of it the device was busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, ms, _ in kernels)
    kernels.sort(key=lambda r: -r[1])
    by_class = {"port kernels": 0.0, "GEMM": 0.0, "other": 0.0}  # device ms
    for name, ms, _ in kernels:
        if "flash::" in name or "raster_tile" in name:
            by_class["port kernels"] += ms
        elif any(tag in name for tag in ("gemm", "gemv", "nvjet", "cutlass")):
            by_class["GEMM"] += ms
        else:
            by_class["other"] += ms
    return {label: {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
                    "by_class_ms": by_class, "launches": sum(count for _, _, count in kernels),
                    "top": [[name[:60], ms, count] for name, ms, count in kernels[:top]]}}


def module_device_ms(fn, modules: dict) -> dict:
    """Device ms of the kernels launched inside each module class's forward
    over one call of `fn` ({label: nn.Module class}, each forward wrapped in
    a torch.profiler range while it runs), and the call's busy total."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    originals = {label: cls.forward for label, cls in modules.items()}

    def ranged(label, forward):
        def wrapped(self, *args, **kwargs):
            with record_function(label):
                return forward(self, *args, **kwargs)
        return wrapped

    fn()
    torch.cuda.synchronize()
    try:
        for label, cls in modules.items():
            cls.forward = ranged(label, originals[label])
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        for label, cls in modules.items():
            cls.forward = originals[label]
    # A range's kernels are those of its host-side event and its children;
    # its device-side annotation (the range's span on the card, gaps
    # included) counts neither there nor in the busy total.
    out = dict.fromkeys(modules, 0.0)
    out["busy"] = 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name in modules:
            out[e.name] += e.device_time_total / 1e3
        elif e.device_type == DeviceType.CUDA and e.name not in modules and not getattr(e, "is_user_annotation", False):
            out["busy"] += e.self_device_time_total / 1e3
    return out


def render_frame(renderer, mesh, dev):
    """One RES² frame holding four copies of the mesh at seeded rotations,
    one per image quadrant at z = 2 m: (image [H, W, 3], masks [4, H, W],
    boxes [4, 4], true poses [4, 4, 4])."""
    from freepose_tpu_torch.geometry.boxes import mask_to_bbox
    from freepose_tpu_torch.geometry.rotation import quat_to_matrix

    rng = np.random.default_rng(SEED + 1)
    poses = torch.eye(4, device=dev).repeat(N_PROPOSALS, 1, 1)
    poses[:, :3, :3] = quat_to_matrix(torch.as_tensor(rng.normal(size=(N_PROPOSALS, 4)), dtype=torch.float32,
                                                      device=dev))
    poses[:, :3, 3] = torch.tensor([[-0.35, -0.35, 2.0], [0.35, -0.35, 2.0], [-0.35, 0.35, 2.0],
                                    [0.35, 0.35, 2.0]], device=dev)
    rgb, depth = renderer.render_from_poses(mesh, poses)  # [4, R, R, 3], [4, R, R]
    z = torch.where(depth > 0, depth, torch.inf)
    front = z.argmin(dim=0)
    hit = torch.isfinite(z.amin(dim=0))
    image = rgb.gather(0, front[None, ..., None].expand(1, -1, -1, 3))[0]
    masks = (front[None] == torch.arange(N_PROPOSALS, device=dev)[:, None, None]) & hit[None]
    return image, masks, mask_to_bbox(masks), poses


def phase_main(dev, mesh) -> tuple[dict, dict]:
    import dataclasses

    from freepose_tpu_torch.models.dinov2 import VIT_L14_REG, DinoFeatureExtractor
    from freepose_tpu_torch.ops.attention import dense_attention, flash_attention_fn
    from freepose_tpu_torch.pipeline.pose_estimator import CoarsePoseEstimator
    from freepose_tpu_torch.pipeline.proposals import extract_proposals
    from freepose_tpu_torch.pipeline.renderer import TemplateRenderer
    from freepose_tpu_torch.pipeline.template_bank import TemplateBank, normalize_feats

    cfg = dataclasses.replace(VIT_L14_REG, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    extractor = DinoFeatureExtractor(cfg, params=random_dinov2_params(cfg), device=dev)
    load_s = time.perf_counter() - t0

    def feature_fn(imgs):
        return extractor(imgs, layer=DINO_LAYER, feature_type="patch")

    renderer = TemplateRenderer(n_poses=N_VIEWS, resolution=RES, device=dev)
    bank = TemplateBank(feature_fn, renderer=renderer, batch_size=BANK_BATCH, device=dev)
    estimator = CoarsePoseEstimator(feature_fn, bank)

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    pack = bank.build_pack("smoke_torus", mesh)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    pack_launches = {name: n for name, n in read_launches().items() if name in ("K1", "K2")}
    t0 = time.perf_counter()
    bank.build_pack("smoke_torus", mesh)  # again, warm
    torch.cuda.synchronize()
    pack_warm_s = time.perf_counter() - t0

    image, masks, boxes, true_poses = render_frame(renderer, mesh, dev)
    prop = extract_proposals(image, masks, boxes, target_size=RES)
    scales = np.full(N_PROPOSALS, 0.25, np.float32)  # true metric half-extent of the frame's meshes
    frame_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        outs = estimator.estimate_batch(prop.proposals, [pack] * N_PROPOSALS, renderer.k,
                                        boxes.float(), scales)
        torch.cuda.synchronize()
        frame_times.append(time.perf_counter() - t0)
    launches = read_launches()

    # What came out: pack and poses well formed.
    feats = pack.feats
    n_views = N_VIEWS
    grid = (RES // cfg.patch_size) ** 2
    assert feats.shape == (n_views, grid, cfg.hidden_size) and torch.isfinite(feats.float()).all()
    assert torch.allclose(feats.float().norm(dim=-1), torch.ones((), device=dev), atol=1e-2)
    for s in (pack.pc_min, pack.pc_max, pack.pc_mean):
        assert s.shape == (n_views, 3) and torch.isfinite(s).all()
    assert bool((pack.pc_max[:, 2] >= pack.pc_min[:, 2]).all()) and bool((pack.pc_mean[:, 2] > 0).all())
    tcos = torch.stack([o.tcos for o in outs])  # [P, 3, 4, 4]
    scores = torch.stack([o.scores for o in outs])
    rot = tcos[..., :3, :3]
    orth_err = float((rot @ rot.transpose(-1, -2) - torch.eye(3, device=dev)).abs().max())
    assert torch.isfinite(tcos).all() and torch.isfinite(scores).all() and orth_err < 1e-4
    assert bool((tcos[..., 2, 3] > 0).all()) and bool((scores[:, :-1] >= scores[:, 1:]).all())

    # The same ViT with the plain attention on 8 of the pack's crops: the
    # kernel path's features agree with it at bf16 accuracy.
    props8, _, _ = renderer.generate_proposals(*renderer.render_from_poses(mesh, renderer.poses[:8]))
    ref_feats = normalize_feats(feature_fn(props8).float())
    for blk in extractor.model.blocks:
        blk.attn.attention_fn = dense_attention
    plain_feats = normalize_feats(feature_fn(props8).float())
    for blk in extractor.model.blocks:
        blk.attn.attention_fn = flash_attention_fn
    cos_min = float((ref_feats * plain_feats).sum(-1).min())
    if cos_min < 0.99:
        raise AssertionError(f"ViT features with K2 vs plain attention: min patch cosine {cos_min}")

    profile = profile_device_time(lambda: feature_fn(props8.repeat(BANK_BATCH // 8, 1, 1, 1)), "vit_batch")
    profile.update(profile_device_time(
        lambda: estimator.estimate_batch(prop.proposals, [pack] * N_PROPOSALS, renderer.k, boxes.float(), scales),
        "frame"))

    frame_s = float(np.median(frame_times))
    result = dict(weights_load_s=load_s, pack_s=pack_s, pack_warm_s=pack_warm_s, pack_launches=pack_launches,
                  frame_s=frame_s, proposals_per_s=N_PROPOSALS / frame_s, launches=launches,
                  scores_top1=scores[:, 0].tolist(), z_top1=tcos[:, 0, 2, 3].tolist(),
                  z_true=true_poses[:, 2, 3].tolist(), scores_finite=bool(torch.isfinite(scores).all()),
                  rot_orth_err=orth_err,
                  view_top1=[int(o.view_indices[0]) for o in outs],
                  kernel_vs_plain_min_patch_cos=cos_min,
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, profile=profile)
    log("main", **result)
    if min(launches["K1"], launches["K2"], launches["launches_by_kernel"]["sm90"]) <= 0:
        raise AssertionError(f"main path did not launch every kernel: {launches}")
    return result, launches


def synthetic_video(seed: int = SEED):
    """Seeded VIDEO_FRAMES-frame uint8 video of VIDEO_HW (1280x720): a
    blocky low-frequency background with pixel noise, a red ellipse drifting
    right and a blue rectangle drifting down-left. Returns (frames
    [T, H, W, 3], boxes [T, 2, 4] xyxy: each object's box on each frame,
    masks [T, 2, H, W] bool: each object's pixels as drawn, the ellipse less
    what the rectangle covers)."""
    rng = np.random.default_rng(seed + 3)
    h, w = VIDEO_HW
    sy, sx = h / 720, w / 1280  # the layout is drawn for 1280x720
    bg = np.kron(rng.random((9, 16, 3)), np.ones((h // 9, w // 16, 1))) * 120
    yy, xx = np.mgrid[:h, :w]
    frames, boxes, masks = [], [], []
    for t in range(VIDEO_FRAMES):
        img = bg + rng.random((h, w, 3)) * 30
        cx, cy, rx, ry = (380 + 12 * t) * sx, 360 * sy, 170 * sx, 120 * sy
        x1, y1, x2, y2 = (820 - 8 * t) * sx, (250 + 6 * t) * sy, (1120 - 8 * t) * sx, (510 + 6 * t) * sy
        ellipse = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1
        rect = np.zeros((h, w), bool)
        rect[int(y1):int(y2), int(x1):int(x2)] = True
        img[ellipse] = [230, 70, 50]
        img[rect] = [50, 110, 235]
        frames.append(img.clip(0, 255).astype(np.uint8))
        boxes.append([[cx - rx, cy - ry, cx + rx, cy + ry], [x1, y1, x2, y2]])
        masks.append([ellipse & ~rect, rect])
    return np.stack(frames), np.asarray(boxes, np.float32), np.asarray(masks)


def plain_attention_auto(q, k, v, scale, kv_mask=None):
    """flash_attention_auto with every call on the plain version."""
    from freepose_tpu_torch.ops.attention import dense_attention_masked

    return dense_attention_masked(q, k, v, scale, kv_mask)


def phase_video(dev) -> tuple[dict, dict]:
    import contextlib
    import io

    from PIL import Image

    from freepose_tpu_torch.datasets.video import load_frame_dir
    from freepose_tpu_torch.ops import attention
    from freepose_tpu_torch.scripts import extract_proposals_ground_video as cli
    from freepose_tpu_torch.scripts.common import load_dino_extractor

    shutil.rmtree(WORK_DIR, ignore_errors=True)
    (WORK_DIR / "frames").mkdir(parents=True)
    frames, boxes, drawn = synthetic_video()
    boxes0 = boxes[0]
    for t, frame in enumerate(frames):
        Image.fromarray(frame).save(WORK_DIR / "frames" / f"{t:05d}.png", compress_level=1)
    np.save(WORK_DIR / "boxes.npy", boxes0)
    np.save(WORK_DIR / "boxes_by_frame.npy", boxes)
    np.save(WORK_DIR / "drawn_masks0.npy", drawn[0])
    del drawn
    bank = np.random.default_rng(SEED + 4).standard_normal((BANK_ROWS, BANK_DIM), np.float32)
    np.save(WORK_DIR / "bank.npy", bank)
    names = [f"mesh_{i:05d}" for i in range(BANK_ROWS)]
    (WORK_DIR / "filelist.txt").write_text("\n".join(names) + "\n")
    out_json = WORK_DIR / "proposals.json"
    argv = ["--video-dir", str(WORK_DIR / "frames"), "--bank", str(WORK_DIR / "bank.npy"),
            "--filelist", str(WORK_DIR / "filelist.txt"), "--out", str(out_json), "--detector", "boxes",
            "--boxes", str(WORK_DIR / "boxes.npy"), "--layer", str(DINO_LAYER),
            "--min-mask-px", str(MIN_MASK_PX), "--device", str(dev)]

    # The path, once, through the CLI a user calls.
    torch.cuda.synchronize()
    reset_launches()
    cli_out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(cli_out):
        cli.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = read_launches()
    props = json.loads(out_json.read_text())
    tracks = sorted({p["track_id"] for p in props})
    for p in props:
        assert p["mesh"] in names and math.isfinite(p["score"]) and 0 <= p["image_id"] < VIDEO_FRAMES, p
        assert p["bbox"][2] > 0 and p["bbox"][3] > 0 and p["track_id"] in range(VIDEO_OBJECTS), p

    # The same functions, measured: propagation alone with launches per
    # frame, then retrieval of each frame's masks.
    frames = load_frame_dir(WORK_DIR / "frames")
    predictor = cli.load_video_predictor(None, device=dev)
    extractor = load_dino_extractor(None, device=dev)
    bank_dev = torch.as_tensor(bank / np.maximum(np.linalg.norm(bank, axis=-1, keepdims=True), 1e-12), device=dev)
    del bank

    def prompted():
        state = predictor.init_state(frames)
        for i, box in enumerate(boxes0):
            state = predictor.add_new_points_or_box(state, 0, obj_id=i, box=box)
        return state

    sam_ms, per_frame, masks_k = [], [], []
    gen = predictor.propagate_in_video(prompted(), binarize=True, chunk=1)  # frame at a time
    while True:
        before = read_launches()
        t0 = time.perf_counter()
        item = next(gen, None)
        if item is None:
            break
        torch.cuda.synchronize()
        sam_ms.append((time.perf_counter() - t0) * 1e3)
        after = read_launches()
        per_frame.append({k: after[k] - before[k] for k in ("K2", "K4")})
        masks_k.append(item[3])
    # Every frame: K2 in each global block of the trunk; every frame that
    # reads memory (all but the prompted one, with one object group): K2 and
    # K4 in each memory-attention layer. Hiera-L: 3; 4 layers. The second
    # tracking frame captures the step's graphs: a warm-up step, then the
    # replay, so its memory attention launches twice.
    hiera, layers = predictor.config.sam.hiera, predictor.config.mem.num_layers
    n_global = sum(1 for i in hiera.global_attention_blocks if i < sum(hiera.blocks_per_stage))
    step = {"K2": n_global + layers, "K4": layers}
    expected = [{"K2": n_global, "K4": 0}, step, {"K2": n_global + 2 * layers, "K4": 2 * layers}] + \
        [step] * (VIDEO_FRAMES - 3)
    if per_frame != expected:
        raise AssertionError(f"kernel launches per frame {per_frame}, expected {expected}")
    ret_ms, n_scored = [], 0
    for t in range(VIDEO_FRAMES):
        t0 = time.perf_counter()
        n_scored += len(cli.retrieve_frame(extractor, bank_dev, frames[t], masks_k[t], DINO_LAYER, MIN_MASK_PX))
        torch.cuda.synchronize()
        ret_ms.append((time.perf_counter() - t0) * 1e3)

    gen = predictor.propagate_in_video(prompted(), binarize=True, chunk=1)
    for _ in range(4):
        next(gen)

    def one_frame():
        t, _, _, masks = next(gen)
        cli.retrieve_frame(extractor, bank_dev, frames[t], masks, DINO_LAYER, MIN_MASK_PX)

    profile = profile_device_time(one_frame, "video_frame", top=16)
    gen.close()

    # Kernels vs plain attention on the whole propagation: logits and masks.
    def propagate(plain: bool):
        kernel_auto = attention.flash_attention_auto
        if plain:
            attention.flash_attention_auto = plain_attention_auto
        try:
            return [(low, high > 0) for _, _, low, high in predictor.propagate_in_video(prompted())]
        finally:
            attention.flash_attention_auto = kernel_auto

    runs = {}
    for plain in (False, True):
        before = read_launches()
        runs[plain] = propagate(plain)
        after = read_launches()
        assert (after["K2"] > before["K2"]) != plain and (after["K4"] > before["K4"]) != plain, (before, after)
    ious, logit_diff, logit_scale = [], 0.0, 0.0
    for (low_k, high_k), (low_p, high_p) in zip(runs[False], runs[True]):
        logit_diff = max(logit_diff, float(np.abs(low_k - low_p).max()))
        logit_scale = max(logit_scale, float(np.abs(low_p).max()))
        for o in range(VIDEO_OBJECTS):
            union = int((high_k[o] | high_p[o]).sum())
            ious.append(int((high_k[o] & high_p[o]).sum()) / union if union else 1.0)
    mask_px = [[int(m.sum()) for m in masks] for masks in masks_k]
    np.save(WORK_DIR / "mask_px.npy", np.asarray(mask_px))

    result = dict(frames=VIDEO_FRAMES, frame_hw=list(VIDEO_HW), objects=VIDEO_OBJECTS, bank_rows=BANK_ROWS,
                  cli_s=cli_s, cli_last_line=cli_out.getvalue().strip().splitlines()[-1], launches=launches,
                  proposals=len(props), tracks=len(tracks), meshes_chosen=sorted({p["mesh"] for p in props}),
                  sam2_ms_per_frame=float(np.median(sam_ms[1:])), sam2_prompt_frame_ms=sam_ms[0],
                  sam2_ms=sam_ms, retrieval_ms_per_frame=float(np.median(ret_ms)), retrieval_ms=ret_ms,
                  masks_scored=n_scored, mask_px=mask_px, launches_per_frame=per_frame,
                  iou_kernel_vs_plain_mean=float(np.mean(ious)), iou_kernel_vs_plain_min=float(np.min(ious)),
                  low_res_logit_max_abs_diff=logit_diff, low_res_logit_max_abs=logit_scale,
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, profile=profile)
    log("video", **result)
    if min(launches["K2"], launches["K4"], launches["combine"], launches["key_tiles"],
           launches["launches_by_kernel"]["sm90"]) <= 0:
        raise AssertionError(f"video path did not launch every kernel: {launches}")
    if not props or n_scored == 0:
        raise AssertionError(f"video path retrieved no proposal: {len(props)} proposals, {n_scored} scored")
    if np.mean(ious) < VIDEO_IOU_MIN or logit_diff > VIDEO_LOGIT_ATOL:
        raise AssertionError(f"SAM2 masks, kernels vs plain attention: mean IoU {np.mean(ious)}, "
                             f"low-res logits max abs diff {logit_diff}")
    return result, launches


def plain_attention_bias_auto(q, k, v, scale, bias):
    """flash_attention_bias_auto with every call on the plain version."""
    from freepose_tpu_torch.ops.attention import dense_attention_bias

    return dense_attention_bias(q, k, v, scale, bias)


def phase_scale(dev) -> tuple[dict, dict]:
    """compute_scale_video through its CLI on the video phase's frames and
    proposal JSON: CLIP ViT-bigG/14 (random weights drawn on the card),
    ZoeD_N from a .npz of seeded random parameters in the JAX layout, a
    seeded 2,201-name prior, k = 11; all fp32."""
    import contextlib
    import gc
    import io

    from freepose_tpu_torch.datasets.video import load_frame_dir
    from freepose_tpu_torch.geometry.camera import default_video_intrinsics
    from freepose_tpu_torch.io.proposals_json import proposal_bbox_xyxy, proposal_mask
    from freepose_tpu_torch.models import zoedepth
    from freepose_tpu_torch.models.convert import random_zoedepth_params, save_params
    from freepose_tpu_torch.ops import attention
    from freepose_tpu_torch.pipeline.proposals import extract_proposals
    from freepose_tpu_torch.pipeline.scale_estimator import ClipPriorScaleEstimator, depth_scales
    from freepose_tpu_torch.scripts import compute_scale_video as cli
    from freepose_tpu_torch.scripts.compute_scale import load_clip, make_tokenizer

    rng = np.random.default_rng(SEED + 6)
    prior = {f"object {i:04d}": float(s) for i, s in enumerate(rng.uniform(0.02, 0.5, PRIOR_NAMES))}
    (WORK_DIR / "prior.json").write_text(json.dumps(prior))
    t0 = time.perf_counter()
    save_params(random_zoedepth_params(zoedepth.DepthConfig(), seed=SEED + 7), WORK_DIR / "zoed_n.npz")
    weights_s = time.perf_counter() - t0
    weights_gb = (WORK_DIR / "zoed_n.npz").stat().st_size / 1e9
    argv = ["--video-dir", str(WORK_DIR / "frames"), "--proposals", str(WORK_DIR / "proposals.json"),
            "--scale-file", str(WORK_DIR / "prior.json"), "--query-k", str(QUERY_K),
            "--depth-weights", str(WORK_DIR / "zoed_n.npz"), "--out", str(WORK_DIR / "scaled.json"),
            "--device", str(dev)]

    # The path, once, through the CLI a user calls; depth forwards counted.
    forwards = []
    predict = zoedepth.MetricDepthEstimator.predict

    def counted_predict(self, *args, **kwargs):
        forwards.append(1)
        return predict(self, *args, **kwargs)

    torch.cuda.synchronize()
    reset_launches()
    cli_out = io.StringIO()
    zoedepth.MetricDepthEstimator.predict = counted_predict
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(cli_out):
            cli.main(argv)
        torch.cuda.synchronize()
    finally:
        zoedepth.MetricDepthEstimator.predict = predict
    cli_s = time.perf_counter() - t0
    launches = read_launches()
    props = json.loads((WORK_DIR / "proposals.json").read_text())
    scaled = json.loads((WORK_DIR / "scaled.json").read_text())
    per_track: dict = {}
    for p in scaled:
        per_track.setdefault(p["track_id"], set()).add(p["scale"])
    scales = {str(t): sorted(s) for t, s in per_track.items()}
    gc.collect()
    torch.cuda.empty_cache()

    # The same functions, measured.
    frames = load_frame_dir(WORK_DIR / "frames")
    h, w = frames.shape[1:3]
    k = default_video_intrinsics(w, h, device=dev)
    t0 = time.perf_counter()
    depth_est = zoedepth.MetricDepthEstimator.from_weights(str(WORK_DIR / "zoed_n.npz"), device=dev)
    depth_load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    clip = load_clip(None, device=dev)
    torch.cuda.synchronize()
    clip_init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    est = ClipPriorScaleEstimator(clip, make_tokenizer(None, clip.config), scale_file=WORK_DIR / "prior.json",
                                  query_k=QUERY_K)
    torch.cuda.synchronize()
    prior_encode_s = time.perf_counter() - t0

    def timed(fn, reps):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(out))

    depth_ms = timed(lambda: depth_est.predict(frames[0]), reps=5)
    p0 = props[0]
    mask = torch.as_tensor(proposal_mask(p0), device=dev)
    box = torch.as_tensor(proposal_bbox_xyxy(p0).astype(np.float32), device=dev)
    prop = extract_proposals(torch.as_tensor(frames[p0["image_id"]], device=dev), mask[None], box[None],
                             target_size=clip.config.image_size, bbox_extend=0.0)
    clip_ms = timed(lambda: est.estimate(prop), reps=5)
    depth0 = torch.as_tensor(depth_est.predict(frames[p0["image_id"]]), device=dev)
    depth_scales_ms = timed(lambda: depth_scales(depth0, k, mask[None]), reps=5)
    profile = profile_device_time(lambda: depth_est.predict(frames[0]), "depth_forward", top=12)
    del clip, est
    gc.collect()
    torch.cuda.empty_cache()

    # One frame's depth with K5 vs with every biased attention on the plain version.
    depths, per_forward = {}, {}
    kernel_auto = attention.flash_attention_bias_auto
    for plain in (False, True):
        before = read_launches()["K5"]
        if plain:
            attention.flash_attention_bias_auto = plain_attention_bias_auto
        try:
            depths[plain] = depth_est.predict(frames[0])
        finally:
            attention.flash_attention_bias_auto = kernel_auto
        per_forward[plain] = read_launches()["K5"] - before
    depth_diff = float(np.abs(depths[False] - depths[True]).max())
    depth_max = float(np.abs(depths[True]).max())

    result = dict(frames=len(frames), proposals=len(props), prior_names=PRIOR_NAMES, query_k=QUERY_K,
                  cli_s=cli_s, cli_last_line=cli_out.getvalue().strip().splitlines()[-1], depth_forwards=len(forwards),
                  launches=launches, scales_by_track=scales, depth_weights_gb=weights_gb, depth_weights_write_s=weights_s,
                  depth_load_s=depth_load_s, clip_init_s=clip_init_s, prior_encode_s=prior_encode_s,
                  zoed_ms_per_frame=depth_ms, clip_ms_per_proposal=clip_ms, depth_scales_ms_per_mask=depth_scales_ms,
                  depth_kernel_vs_plain_max_abs_diff=depth_diff, depth_max=depth_max, depth_rel_tol=DEPTH_REL_TOL,
                  depth_min=float(depths[False].min()), k5_launches_per_forward_kernel_plain=[per_forward[False],
                                                                                           per_forward[True]],
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, profile=profile)
    log("scale", **result)
    n_blocks = zoedepth.DepthConfig().beit.num_layers
    if not forwards or launches["K5"] < n_blocks * len(forwards) or launches["K5"] <= 0:
        raise AssertionError(f"scale path: {launches['K5']} K5 launches for {len(forwards)} depth forwards")
    if attention.k5_config(K5_SHAPE[1], K5_SHAPE[2], K5_SHAPE[2], attention._num_sms(dev)) > 1 and \
            launches["K5_combine"] != launches["K5"]:
        raise AssertionError(f"scale path: K5 splits its keys at ZoeD_N's shape, but its combine launched "
                             f"{launches['K5_combine']} times for {launches['K5']} K5 launches")
    if len(scaled) != len(props) or not all(math.isfinite(p["scale"]) and p["scale"] > 0 for p in scaled):
        raise AssertionError(f"scale path: scales not finite and > 0: {scales}")
    if any(len(s) != 1 for s in per_track.values()):
        raise AssertionError(f"scale path: a track with more than one scale: {scales}")
    if per_forward != {False: n_blocks, True: 0}:
        raise AssertionError(f"K5 launches per forward, kernel and plain: {per_forward}")
    if not depth_diff <= DEPTH_REL_TOL * depth_max:
        raise AssertionError(f"ZoeD_N depth with K5 vs plain attention: max abs diff {depth_diff} "
                             f"(largest depth {depth_max})")
    return result, launches


# Frame 1's 32 neighbourhood scores (mean patch cosines of bf16 DINOv2-L
# features), kernels vs plain versions: the kernels round attention in bf16
# against other maxima, and each difference is carried through 22 blocks
# before 900 patch cosines are averaged. 1e-3 is 85x the difference measured
# on the H100 (1.2e-5) and 110x below the error of scores read one slot off
# (0.11), which must fail it.
REFINE_SCORE_ATOL = 1e-3
REFINE_ORTH_ATOL = 1e-4
# The fine refine's defaults (dino_inference_video): the 20,000-pose fine
# grid, a 15° neighbourhood capped at 32 views, a 256-slot cache per track,
# the stream miss bucket of AutoRefineChain.
N_FINE, N_NEIGHBORS, NEIGHBORHOOD, FINE_CACHE, MISS_BUCKET = 20000, 32, 15.0, 256, 16
BATCH_INVARIANCE_CROPS = 17


def refine_kernels_vs_plain(est, extractor, mesh_key, mesh, crop, cmask, k, bbox, scale, prev) -> dict:
    """One fine refine step from a cold cache (prev: the pose it starts
    from) with the kernels and with every attention call and K1 on their
    plain versions: the neighbourhood's render masks (mismatches), its
    scores (max abs error) and, as the tolerance's own check, the kernels'
    scores read one slot off against the plain ones; launches of each run."""
    from freepose_tpu_torch.ops import rasterizer_cuda
    from freepose_tpu_torch.ops.attention import dense_attention, flash_attention_fn
    from freepose_tpu_torch.ops.rasterizer_cuda import raster_tile, raster_tile_plain
    from freepose_tpu_torch.pipeline.fine_cache import cached_refine_auto_step, init_device_cache
    from freepose_tpu_torch.pipeline.online_pose_estimator import rescore_views, select_neighborhood
    from freepose_tpu_torch.pipeline.template_bank import normalize_feats

    renderer = est.renderer
    grid = RES // extractor.config.patch_size
    runs = {}
    for plain in (False, True):
        before = read_launches()
        if plain:
            rasterizer_cuda.raster_tile = raster_tile_plain
            for blk in extractor.model.blocks:
                blk.attn.attention_fn = dense_attention
        try:
            state = init_device_cache(FINE_CACHE, grid * grid, extractor.config.hidden_size, RES, N_FINE,
                                      extractor.config.dtype, crop.device)
            cached_refine_auto_step(
                state, est.fine_poses, prev, prev, *est._padded_mesh(mesh_key, mesh), renderer.k, crop, cmask, k,
                est._f32(bbox), est._f32(scale), extractor=extractor, layer=DINO_LAYER, settings=renderer.settings,
                pose_chunk=renderer.pose_chunk, resolution=RES, mask_scores=False,
                rendering_scale=est.rendering_scale, neighborhood_deg=NEIGHBORHOOD, n_neighbors=N_NEIGHBORS,
                miss_bucket=N_NEIGHBORS)
            qf = normalize_feats(extractor(crop[None], layer=DINO_LAYER, feature_type="patch")[0])
        finally:
            rasterizer_cuda.raster_tile = raster_tile
            for blk in extractor.model.blocks:
                blk.attn.attention_fn = flash_attention_fn
        after = read_launches()
        _, idx, valid = select_neighborhood(est.fine_poses, prev, NEIGHBORHOOD, N_NEIGHBORS)
        slots = state.slot_table[idx].long()
        assert bool((slots >= 0).all())
        runs[plain] = dict(state=state, slots=slots, valid=valid, qf=qf,
                           launches={key: after[key] - before[key] for key in ("K1", "K2")})

    def scores_of(run, shift=0):
        """The neighbourhood's scores; shift=1 reads each view from the
        slot of the view before it (the wrong stand-in)."""
        slots = run["slots"].roll(shift)
        st = run["state"]
        return rescore_views(st.feats[slots], run["qf"], run["valid"], st.masks[slots], cmask, grid, False)

    kernel_scores, plain_scores = scores_of(runs[False]), scores_of(runs[True])
    valid = runs[False]["valid"]
    return {"render_mask_mismatches": int((runs[False]["state"].masks[runs[False]["slots"]] !=
                                           runs[True]["state"].masks[runs[True]["slots"]]).sum()),
            "score_max_abs_err": float((kernel_scores - plain_scores)[valid].abs().max()),
            "atol": REFINE_SCORE_ATOL,
            "one_slot_off_max_abs_err": float((scores_of(runs[False], shift=1) - plain_scores)[valid].abs().max()),
            "launches": {"kernels": runs[False]["launches"], "plain": runs[True]["launches"]}}


def phase_refine(dev, mesh) -> tuple[dict, dict]:
    """render_templates and dino_inference_video through their CLIs on the
    scale phase's scaled.json (the torus as every retrieved mesh), with the
    refine defaults: AutoRefineChain on a 256-slot cache per track."""
    import contextlib
    import io

    from freepose_tpu_torch.datasets.template import WebTemplateDataset
    from freepose_tpu_torch.datasets.video import load_frame_dir
    from freepose_tpu_torch.geometry.boxes import mask_to_bbox
    from freepose_tpu_torch.geometry.camera import default_video_intrinsics
    from freepose_tpu_torch.geometry.crop import crop_resize_pad
    from freepose_tpu_torch.geometry.rotation import template_poses
    from freepose_tpu_torch.io.bop_csv import read_results_csv
    from freepose_tpu_torch.io.mesh import load_obj, save_obj
    from freepose_tpu_torch.io.proposals_json import proposal_bbox_xyxy, proposal_mask
    from freepose_tpu_torch.models.convert import save_params
    from freepose_tpu_torch.models.dinov2 import VIT_L14_REG
    from freepose_tpu_torch.ops.rasterizer_cuda import prologue, raster_tile
    from freepose_tpu_torch.pipeline import fine_cache
    from freepose_tpu_torch.pipeline.online_pose_estimator import (AutoRefineChain, OnlinePoseEstimator,
                                                                   render_view_block)
    from freepose_tpu_torch.pipeline.proposals import extract_proposals
    from freepose_tpu_torch.pipeline.renderer import TemplateRenderer
    from freepose_tpu_torch.pipeline.template_bank import TemplateBank, normalize_feats
    from freepose_tpu_torch.scripts import dino_inference_video as cli
    from freepose_tpu_torch.scripts import render_templates
    from freepose_tpu_torch.scripts.common import load_dino_extractor

    # DINOv2-L weights as in the main phase (LayerScale 0.1, so that each
    # block, attention included, moves the features), through --weights.
    t0 = time.perf_counter()
    save_params(random_dinov2_params(VIT_L14_REG), WORK_DIR / "dinov2.npz")
    weights_s = time.perf_counter() - t0
    scaled = json.loads((WORK_DIR / "scaled.json").read_text())
    names = sorted({p["mesh"] for p in scaled})
    for name in names:
        (WORK_DIR / "meshes" / name).mkdir(parents=True, exist_ok=True)
        save_obj(mesh, WORK_DIR / "meshes" / name / f"{name}.obj")
    (WORK_DIR / "refine_meshes.txt").write_text("\n".join(names) + "\n")
    common = ["--filelist", str(WORK_DIR / "refine_meshes.txt"), "--mesh-dir", str(WORK_DIR / "meshes"),
              "--device", str(dev)]
    argv = ["--video-dir", str(WORK_DIR / "frames"), "--proposals", str(WORK_DIR / "scaled.json"),
            "--wds-dir", str(WORK_DIR / "shards"), "--weights", str(WORK_DIR / "dinov2.npz"),
            "--layer", str(DINO_LAYER), *common]

    # The path, once, through the CLIs a user calls.
    torch.cuda.synchronize()
    reset_launches()
    cli_out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(cli_out):
        render_templates.main(["--out", str(WORK_DIR / "shards"), *common])
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(cli_out):
        cli.main([*argv, "--out", str(WORK_DIR / "chain.csv")])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = read_launches()
    rows = read_results_csv(WORK_DIR / "chain.csv", t_scale=1.0)
    orth = max(float(np.abs(r.R @ r.R.T - np.eye(3)).max()) for r in rows)
    finite = all(np.isfinite(r.R).all() and np.isfinite(r.t).all() and math.isfinite(r.score) for r in rows)
    t_z_min = min(float(r.t[2]) for r in rows)

    # Chain against the serial cached path, through the CLI.
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(cli_out):
        cli.main([*argv, "--out", str(WORK_DIR / "serial.csv"), "--chain-refine", "0"])
    torch.cuda.synchronize()
    cli_serial_s = time.perf_counter() - t0
    serial = read_results_csv(WORK_DIR / "serial.csv", t_scale=1.0)
    same_rows = [(a.im_id, str(a.obj_id)) for a in rows] == [(b.im_id, str(b.obj_id)) for b in serial]
    pose_agree = sum(bool(np.array_equal(a.R, b.R)) for a, b in zip(rows, serial))
    score_diff = max(abs(a.score - b.score) for a, b in zip(rows, serial))

    # The same functions, measured: the CLI's estimator and packs, each
    # frame's crops made once.
    frames = load_frame_dir(WORK_DIR / "frames")
    h, w = frames.shape[1:3]
    k = default_video_intrinsics(w, h, device=dev)
    extractor = load_dino_extractor(str(WORK_DIR / "dinov2.npz"), device=dev)

    def feature_fn(imgs):
        return extractor(imgs, layer=DINO_LAYER, feature_type="patch")

    renderer = TemplateRenderer(n_poses=N_VIEWS, device=dev)
    est = OnlinePoseEstimator(feature_fn, TemplateBank(feature_fn, renderer, cache_size=4, device=dev), renderer,
                              n_coarse_poses=N_VIEWS, n_fine_poses=N_FINE, n_neighbors=N_NEIGHBORS,
                              extractor=extractor, feature_layer=DINO_LAYER, fine_cache_capacity=FINE_CACHE)
    templates = WebTemplateDataset(WORK_DIR / "shards", names)
    packs, meshes = {}, {}
    for name in names:
        item = templates.get_template_by_name(name)
        rgb = torch.as_tensor(item["rgb"], device=dev).permute(0, 3, 1, 2)
        crops = crop_resize_pad(rgb, mask_to_bbox(torch.as_tensor(item["masks"], device=dev)), RES)
        packs[name] = est.coarse.bank.pack_from_views(name, crops, torch.as_tensor(item["depth"], device=dev),
                                                      template_poses(rgb.shape[0], device=dev),
                                                      torch.as_tensor(item["intrinsic"], device=dev))
        meshes[name] = load_obj(WORK_DIR / "meshes" / name / f"{name}.obj").normalized()
        del item, rgb, crops
    by_frame: dict = {}
    for p in scaled:
        by_frame.setdefault(p["image_id"], []).append(p)
    objs = {}  # frame -> [(mesh id, crop, crop mask, bbox, scale)]
    for f, plist in by_frame.items():
        masks = torch.as_tensor(np.stack([proposal_mask(p) for p in plist]), device=dev)
        boxes = np.stack([proposal_bbox_xyxy(p).astype(np.float32) for p in plist])
        crop = extract_proposals(torch.as_tensor(frames[f], device=dev), masks, torch.as_tensor(boxes, device=dev),
                                 target_size=RES, bbox_extend=0.2)
        objs[f] = [(p["mesh"], crop.proposals[i], crop.masks[i], boxes[i], float(p.get("scale", 0.1)))
                   for i, p in enumerate(plist)]

    renders = []
    serve_render = fine_cache.render_view_block

    def counted_render(*args, **kwargs):
        renders.append(1)
        return serve_render(*args, **kwargs)

    def run_chains(sync: bool):
        """The CLI's loop: frame 0 of a track coarse, later frames submitted
        to its chain; with sync, each call timed to the card's finish, with
        the miss batches it rendered and the re-dispatches it made."""
        chains, prev, steps = {}, {}, []
        t_all = time.perf_counter()
        for f in sorted(objs):
            for mid, crop, cmask, bbox, scale in objs[f]:
                t0 = time.perf_counter()
                if mid not in prev:
                    prev[mid] = est.coarse.estimate(crop, packs[mid], k, bbox, scale).tcos[0]
                    continue
                ch, seed = chains.get(mid), None
                if ch is None:
                    ch = chains[mid] = AutoRefineChain(est, meshes[mid], mid, neighborhood_deg=NEIGHBORHOOD)
                    seed = prev[mid]
                redispatched, rendered = ch.n_full_redispatch, len(renders)
                ch.submit(crop, cmask, k, bbox, scale, prev_pose=seed)
                if sync:
                    torch.cuda.synchronize()
                    steps.append(dict(frame=f, mesh=mid, ms=(time.perf_counter() - t0) * 1e3,
                                      miss_batches=len(renders) - rendered,
                                      redispatch=ch.n_full_redispatch - redispatched))
        for ch in chains.values():
            ch.finalize_all()
        torch.cuda.synchronize()
        return chains, steps, time.perf_counter() - t_all

    fine_cache.render_view_block = counted_render
    try:
        chains, steps, _ = run_chains(sync=True)
    finally:
        fine_cache.render_view_block = serve_render
    # Hit frames render nothing; miss frames one miss batch (a call that
    # also re-dispatched an earlier frame renders more, and is left out).
    settled = [s for s in steps if s["frame"] >= 2 and not s["redispatch"]]
    hit_ms = [s["ms"] for s in settled if s["miss_batches"] == 0]
    miss_ms = [s["ms"] for s in settled if s["miss_batches"] == 1]
    # The same loop without a sync per frame: its wall time (the coarse
    # frame included) per refine frame.
    _, _, pipelined_s = run_chains(sync=False)
    n_refine = len(steps)

    # One hit step and one miss step, profiled: the first chain's last frame
    # again once its whole neighbourhood is cached, then the same crop from
    # far grid poses (a full neighbourhood of misses, MISS_BUCKET served).
    mid, ch = next(iter(chains.items()))
    f_last = max(f for f in objs if any(o[0] == mid for o in objs[f]))
    _, crop, cmask, bbox, scale = next(o for o in objs[f_last] if o[0] == mid)
    inputs = (crop, cmask, k, est._f32(bbox), est._f32(scale))
    prev = est._f32(ch.results[-1][0])
    ch._step(inputs, prev, N_NEIGHBORS).numpy()  # caches the whole neighbourhood
    packed = []

    def step(pose):
        before = read_launches()
        packed.append(ch._step(inputs, pose, MISS_BUCKET).numpy())
        after = read_launches()
        packed.append({key: after[key] - before[key] for key in ("K1", "K2")})

    profile = profile_device_time(lambda: step(prev), "hit_step", top=12)
    hit_misses, hit_launches = int(packed[-2][18]), packed[-1]
    far = iter(est.fine_poses[[3000, 9000, 15000, 19000]])
    profile.update(profile_device_time(lambda: step(next(far)), "miss_step", top=12))
    miss_misses, miss_launches = int(packed[-2][18]), packed[-1]

    def step_ms(pose):
        t0 = time.perf_counter()
        ch._step(inputs, pose, MISS_BUCKET).numpy()
        return (time.perf_counter() - t0) * 1e3

    # Without the profiler: the hit step again, and miss steps from more far
    # poses (each serves MISS_BUCKET of its 32 misses, as any stream miss
    # step renders a full bucket).
    hit_step_ms = float(np.median([step_ms(prev) for _ in range(5)]))
    miss_step_ms = float(np.median([step_ms(pose) for pose in est.fine_poses[[1000, 5000, 7000, 11000, 17000]]]))
    # A miss batch's render at the stream bucket: K1's prologue, K1, and the
    # whole block (renders, crops, cloud stats).
    padded = est._padded_mesh(mid, meshes[mid])
    poses = est.fine_poses[:MISS_BUCKET]
    ks = renderer.k.expand(MISS_BUCKET, 3, 3)
    settings = renderer.settings
    rows16, slots16 = prologue(*padded, poses, ks, settings)
    miss_render_ms = {
        "prologue": cuda_ms(lambda: prologue(*padded, poses, ks, settings), reps=5),
        "K1": cuda_ms(lambda: raster_tile(rows16, slots16, RES, settings.tile, settings.ambient, False), reps=10),
        "render_view_block": cuda_ms(lambda: render_view_block(*padded, poses, renderer.k, settings,
                                                               renderer.pose_chunk, RES, False), reps=5)}
    del rows16, slots16

    # Batch invariance: one view's features alone and inside a 17-crop batch.
    props, _, _ = render_view_block(*est._padded_mesh(mid, meshes[mid]), est.fine_poses[:BATCH_INVARIANCE_CROPS],
                                    renderer.k, renderer.settings, renderer.pose_chunk, RES, False)
    alone = normalize_feats(feature_fn(props[:1]).float())[0]
    batched = normalize_feats(feature_fn(props).float())[0]
    batch_invariance = float((alone - batched).abs().max())

    # Frame 1 of the first track from a cold cache (the CLI's prev: frame 0's
    # coarse pose), with the kernels and with every attention call and K1 on
    # their plain versions: the neighbourhood's render masks and scores.
    f1 = sorted(f for f in objs if any(o[0] == mid for o in objs[f]))[:2]
    _, c0, _, b0, s0 = next(o for o in objs[f1[0]] if o[0] == mid)
    prev = est.coarse.estimate(c0, packs[mid], k, b0, s0).tcos[0]
    _, crop, cmask, bbox, scale = next(o for o in objs[f1[1]] if o[0] == mid)
    frame1 = refine_kernels_vs_plain(est, extractor, mid, meshes[mid], crop, cmask, k, bbox, scale, prev)
    mask_mismatch, score_err = frame1["render_mask_mismatches"], frame1["score_max_abs_err"]
    off_by_one, frame1_launches = frame1["one_slot_off_max_abs_err"], frame1["launches"]

    result = dict(meshes=len(names), proposals=len(scaled), rows=len(rows), rows_finite=finite, rot_orth_err=orth,
                  t_z_min=t_z_min, render_templates_s=render_s, cli_s=cli_s, launches=launches,
                  cli_last_line=cli_out.getvalue().strip().splitlines()[-1],
                  chain_vs_serial={"cli_serial_s": cli_serial_s, "same_rows": same_rows, "rows": len(serial),
                                   "grid_pose_agrees": pose_agree, "score_max_abs_diff": score_diff},
                  dinov2_weights_write_s=weights_s, hit_step_ms=hit_step_ms, miss_step_ms=miss_step_ms,
                  miss_render_ms=miss_render_ms,
                  refine_frames=n_refine, ms_per_hit_frame=float(np.median(hit_ms)) if hit_ms else None,
                  ms_per_miss_frame=float(np.median(miss_ms)) if miss_ms else None, hit_frames=len(hit_ms),
                  miss_frames=len(miss_ms), cold_frame_ms=[next(s["ms"] for s in steps if s["mesh"] == m)
                                                           for m in chains],
                  steps=steps, chain_ms_per_frame_pipelined=pipelined_s * 1e3 / max(n_refine, 1),
                  misses_per_frame={m: ch.miss_counts for m, ch in chains.items()},
                  full_redispatches={m: ch.n_full_redispatch for m, ch in chains.items()},
                  bucket_switches={m: ch.bucket_switches for m, ch in chains.items()},
                  launches_per_step={"hit": hit_launches, "miss": miss_launches},
                  profiled_step_misses={"hit": hit_misses, "miss": miss_misses},
                  batch_invariance_max_abs=batch_invariance,
                  frame1_kernel_vs_plain={"render_mask_mismatches": mask_mismatch, "score_max_abs_err": score_err,
                                          "atol": REFINE_SCORE_ATOL, "one_slot_off_max_abs_err": off_by_one,
                                          "launches": frame1_launches},
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, profile=profile)
    log("refine", **result)
    if min(launches["K1"], launches["K2_by_dim"].get("64", 0), launches["launches_by_kernel"]["sm90"]) <= 0:
        raise AssertionError(f"refine path did not launch every kernel: {launches}")
    if len(rows) != len(scaled) or not finite or orth > REFINE_ORTH_ATOL or t_z_min <= 0:
        raise AssertionError(f"refine path: {len(rows)} rows for {len(scaled)} proposals, finite {finite}, "
                             f"R orthonormal within {orth}, least t_z {t_z_min}")
    if mask_mismatch or not score_err <= REFINE_SCORE_ATOL:
        raise AssertionError(f"frame 1, kernels vs plain versions: {mask_mismatch} render-mask mismatches, "
                             f"scores max abs err {score_err} (atol {REFINE_SCORE_ATOL})")
    if min(frame1_launches["kernels"].values()) <= 0 or max(frame1_launches["plain"].values()) != 0:
        raise AssertionError(f"frame 1, kernels vs plain versions: launches {frame1_launches}")
    if hit_misses != 0 or miss_misses <= 0:
        raise AssertionError(f"profiled steps: {hit_misses} misses in the hit step, {miss_misses} in the miss step")
    if not off_by_one > REFINE_SCORE_ATOL:
        raise AssertionError(f"the score tolerance {REFINE_SCORE_ATOL} does not fail scores read one slot off: "
                             f"{off_by_one}")
    if not same_rows:
        raise AssertionError("chain and serial refine wrote different rows")
    return result, launches



# Smooth path: the released CoTracker2 width (COTRACKER2, fp32) and DINOv2-B
# (bf16) at 518²; K1 at 518², tile 37 on one 8-pose confidence chunk; K2 at
# DINOv2-B's [16, 12, 1374, 64] (8 crops + 8 renders). The confidence
# chunk's patch features with the kernels against those with every
# attention call and K1 on their plain versions: bf16 attention in 12
# blocks, so a cosine floor as the proposals phase's; render masks
# identical and depth within K1_ATOL; R orthonormal within SMOOTH_ORTH_ATOL.
SMOOTH_CHUNK, SMOOTH_RES, SMOOTH_TILE = 8, 518, 37
SMOOTH_ORTH_ATOL = 1e-3


def video_gt_boxes(boxes: np.ndarray, obj: int) -> np.ndarray:
    """[T, 4] xywh boxes of object `obj` from `synthetic_video`'s per-frame
    xyxy boxes [T, 2, 4], clipped to the frame."""
    h, w = VIDEO_HW
    b = boxes[:, obj].copy()
    b[:, :2] = np.maximum(b[:, :2], 0.0)
    b[:, 2:] = np.minimum(b[:, 2:], [w - 1.0, h - 1.0])
    return np.concatenate([b[:, :2], b[:, 2:] - b[:, :2]], axis=1).astype(np.float32)


def phase_smooth(dev) -> tuple[dict, dict]:
    """filter_predictions, dino_inference_video and smooth_poses_video
    through their CLIs on the earlier phases' files: the frames that the
    scaled proposals' longest track covers from frame 0 on, one proposal
    each (its object's boxes as the video GT), one coarse row per frame,
    then the track refine with the ZNCC chain (the default) and with
    CoTracker2 (--tracker-weights of seeded random parameters at the
    released width); DINOv2-B from a .npz of seeded weights; --interval 12,
    --cap 512. A track lacks a proposal exactly on the frames where its
    tracked mask (the video phase's) is below the video CLI's
    --min-mask-px."""
    import contextlib
    import io

    import torch.nn.functional as F

    from freepose_tpu_torch.datasets.video import load_frame_dir, stage_frames
    from freepose_tpu_torch.geometry.camera import crop_bbox_around_projection, default_video_intrinsics, \
        update_k_with_crop
    from freepose_tpu_torch.geometry.se3 import smooth_transforms
    from freepose_tpu_torch.io.bop_csv import read_results_csv
    from freepose_tpu_torch.io.mesh import load_obj
    from freepose_tpu_torch.models.convert import random_cotracker2_params, save_params
    from freepose_tpu_torch.models.cotracker import PointTracker
    from freepose_tpu_torch.models.cotracker2 import COTRACKER2, CoTracker2Predictor
    from freepose_tpu_torch.models.dinov2 import VIT_B14_REG
    from freepose_tpu_torch.ops import rasterizer_cuda
    from freepose_tpu_torch.ops.attention import (bf16_error_bound, dense_attention, flash_attention_fn,
                                                  flash_attention_k2, sm90_key_tile)
    from freepose_tpu_torch.ops.rasterizer_cuda import prologue, raster_tile, raster_tile_plain
    from freepose_tpu_torch.pipeline.template_bank import normalize_feats
    from freepose_tpu_torch.pipeline.tracking_refiner import RES, TrackingRefiner, quantile_threshold
    from freepose_tpu_torch.scripts import dino_inference_video, filter_predictions
    from freepose_tpu_torch.scripts import smooth_poses_video as cli
    from freepose_tpu_torch.scripts.common import load_dino_extractor

    t0 = time.perf_counter()
    save_params(random_dinov2_params(VIT_B14_REG, seed=SEED + 9), WORK_DIR / "dinov2_vitb.npz")
    save_params(random_cotracker2_params(COTRACKER2, seed=SEED + 10), WORK_DIR / "cotracker2.npz")
    weights_s = time.perf_counter() - t0
    scaled = json.loads((WORK_DIR / "scaled.json").read_text())
    frames_of = {tid: sorted(p["image_id"] for p in scaled if p["track_id"] == tid)
                 for tid in sorted({p["track_id"] for p in scaled})}
    # The CLI takes one coarse row per frame of its video: the video is the
    # frames that the longest track covers from frame 0 on, one proposal each.
    prefix = {tid: fr for tid, fr in frames_of.items() if fr == list(range(len(fr)))}
    if not prefix or max(len(fr) for fr in prefix.values()) < SMOOTH_CHUNK:
        raise AssertionError(f"no track of scaled.json covers frames 0-{SMOOTH_CHUNK - 1}, one proposal each: "
                             f"{frames_of}")
    mask_px = np.load(WORK_DIR / "mask_px.npy")
    big_enough = {tid: [t for t in range(VIDEO_FRAMES) if mask_px[t, tid] >= MIN_MASK_PX] for tid in frames_of}
    if frames_of != big_enough:
        raise AssertionError(f"frames with a proposal per track {frames_of}, frames whose tracked mask holds at "
                             f"least {MIN_MASK_PX} px {big_enough}")
    track = max(prefix, key=lambda tid: len(prefix[tid]))
    n_frames = len(prefix[track])
    (WORK_DIR / "smooth_frames").mkdir(exist_ok=True)
    for path in sorted((WORK_DIR / "frames").glob("*.png"))[:n_frames]:
        shutil.copy(path, WORK_DIR / "smooth_frames" / path.name)
    gt = video_gt_boxes(np.load(WORK_DIR / "boxes_by_frame.npy"), track)[:n_frames]
    np.save(WORK_DIR / "video_gt.npy", {"bboxes": gt}, allow_pickle=True)
    cli_out = io.StringIO()

    # The coarse rows the smooth path reads, through the CLIs a user calls.
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(cli_out):
        filter_predictions.main(["--proposals", str(WORK_DIR / "scaled.json"), "--gt", str(WORK_DIR / "video_gt.npy"),
                                 "--out", str(WORK_DIR / "kept.json")])
    kept = json.loads((WORK_DIR / "kept.json").read_text())
    if sorted(p["image_id"] for p in kept) != list(range(n_frames)):
        raise AssertionError(f"filter_predictions kept {len(kept)} proposals of track "
                             f"{kept[0]['track_id'] if kept else None}, not one per frame")
    with contextlib.redirect_stdout(cli_out):
        dino_inference_video.main(["--video-dir", str(WORK_DIR / "smooth_frames"),
                                   "--proposals", str(WORK_DIR / "kept.json"),
                                   "--wds-dir", str(WORK_DIR / "shards"), "--weights", str(WORK_DIR / "dinov2.npz"),
                                   "--layer", str(DINO_LAYER), "--filelist", str(WORK_DIR / "refine_meshes.txt"),
                                   "--mesh-dir", str(WORK_DIR / "meshes"), "--device", str(dev),
                                   "--out", str(WORK_DIR / "coarse.csv")])
    torch.cuda.synchronize()
    coarse_s = time.perf_counter() - t0
    coarse_launches = read_launches()

    # The path, once: smooth_poses_video through its CLI with each tracker.
    argv = ["--video-dir", str(WORK_DIR / "smooth_frames"), "--poses", str(WORK_DIR / "coarse.csv"),
            "--mesh-dir", str(WORK_DIR / "meshes"), "--weights", str(WORK_DIR / "dinov2_vitb.npz"),
            "--interval", "12", "--device", str(dev)]
    cli_s, rows, tracker_launches = {}, {}, {}
    torch.cuda.synchronize()
    reset_launches()
    for tracker, extra in (("zncc", []), ("cotracker2", ["--tracker", "cotracker2", "--tracker-weights",
                                                         str(WORK_DIR / "cotracker2.npz")])):
        before = read_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(cli_out):
            cli.main([*argv, *extra, "--out", str(WORK_DIR / f"tracked_{tracker}.csv")])
        torch.cuda.synchronize()
        cli_s[tracker] = time.perf_counter() - t0
        after = read_launches()
        tracker_launches[tracker] = {"K1": after["K1"] - before["K1"],
                                     "K2_d64": after["K2_by_dim"].get("64", 0) - before["K2_by_dim"].get("64", 0)}
        rows[tracker] = read_results_csv(WORK_DIR / f"tracked_{tracker}.csv", t_scale=1.0)
    launches = read_launches()
    row_checks = {name: {"rows": len(rs), "frames": sorted(r.im_id for r in rs) == list(range(n_frames)),
                         "rot_orth_err": max(float(np.abs(r.R @ r.R.T - np.eye(3)).max()) for r in rs),
                         "t_finite": all(np.isfinite(r.t).all() for r in rs),
                         "t_z_min": min(float(r.t[2]) for r in rs)} for name, rs in rows.items()}

    # The same functions, measured: the CLI's refiner, trackers and video.
    coarse = sorted(read_results_csv(WORK_DIR / "coarse.csv", t_scale=1.0), key=lambda r: r.im_id)
    frames = load_frame_dir(WORK_DIR / "smooth_frames")
    h, w = frames.shape[1:3]
    k = default_video_intrinsics(w, h)
    mesh = load_obj(WORK_DIR / "meshes" / str(coarse[0].obj_id) / f"{coarse[0].obj_id}.obj").normalized().scaled(
        coarse[0].scale)
    poses = np.stack([np.vstack([np.hstack([r.R, r.t[:, None]]), [0, 0, 0, 1]]) for r in coarse]).astype(np.float32)
    extractor = load_dino_extractor(str(WORK_DIR / "dinov2_vitb.npz"), model="vitb", device=dev)

    def feature_fn(imgs):
        return extractor(imgs, layer=None, feature_type="patch")

    zncc = PointTracker(device=dev)
    ct2 = CoTracker2Predictor(random_cotracker2_params(COTRACKER2, seed=SEED + 10), COTRACKER2, device=dev)
    refiner = TrackingRefiner(feature_fn=feature_fn, tracker=zncc, device=dev)
    staged = stage_frames(frames, dev)
    n = len(frames)

    def timed(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3 / reps

    (inliers, _), conf_ms = timed(lambda: refiner.n_inliers_per_pose(mesh, staged, k, poses, channels_last=True))
    best = int(np.argmax(inliers))
    (query, surface, valid), corr_ms = timed(
        lambda: refiner.compute_2d3d_correspondences(mesh, None, k, poses[best], fetch=False))
    order = torch.argsort(torch.where(valid, 0, valid.shape[0] + 1)
                          + torch.arange(valid.shape[0], device=dev))[:512]
    qs, ss, vs = query[order], surface[order], valid[order]
    idxs = [min(i, n - 1) for i in range(best, best + 12)]
    sub = staged[torch.as_tensor(idxs, device=dev)]
    # ZNCC at the cap the CLI picks with its default --cap-buckets, and at 512.
    zncc_cap = cli.cap_set(512, (128, 256, 512))
    zncc_cap = next((b for b in zncc_cap if b >= int(valid.sum())), zncc_cap[-1])
    _, zncc_cap_ms = timed(lambda: zncc.track_device(sub, qs[:zncc_cap], 0))
    (tr_z, sc_z), zncc_ms = timed(lambda: zncc.track_device(sub, qs, 0))
    (tr_c, vis_c), ct2_ms = timed(lambda: ct2.track(sub, qs.cpu().numpy(), 0), reps=2)
    vis_z = (sc_z > 0.5).cpu().numpy() & vs.cpu().numpy()[None]
    _, pnp_ms = timed(lambda: refiner.compute_pnp_batch(tr_z, ss, vis_z, k), reps=5)
    _, smooth_ms = timed(lambda: smooth_transforms(torch.as_tensor(poses)), reps=5)
    trackers = {"zncc": {"visible_share": float(vis_z.mean()), "ms": zncc_cap_ms, "points": zncc_cap,
                         "ms_at_512": zncc_ms},
                "cotracker2": {"visible_share": float((vis_c & vs.cpu().numpy()[None]).mean()), "ms": ct2_ms,
                               "points": len(order) + ct2.support_grid_size ** 2}}
    chunk = torch.as_tensor(np.minimum(np.arange(SMOOTH_CHUNK), n - 1), device=dev)
    chunk_poses = poses[chunk.cpu().numpy()]
    profile = profile_device_time(lambda: refiner.pose_confidence_batch(mesh, staged[chunk], k, chunk_poses,
                                                                        fetch=False, channels_last=True),
                                  "confidence_chunk", top=10)
    profile.update(profile_device_time(lambda: ct2.track(sub, qs.cpu().numpy(), 0), "cotracker2_interval", top=10))

    # One confidence chunk with the kernels, then with every attention call
    # and K1 on their plain versions: renders, features, confidence.
    kd, pd = torch.as_tensor(k, device=dev), torch.as_tensor(chunk_poses, device=dev)
    pts = torch.as_tensor(mesh.sample_surface(100, seed=42), device=dev)
    new_ks = update_k_with_crop(kd, crop_bbox_around_projection(pd, pts, kd, RES, RES, lamb=1.4), RES, RES)
    padded = refiner._padded(mesh)
    settings = refiner.settings
    rows_, slots = prologue(*padded, pd, new_ks, settings)
    runs = {}
    for plain in (False, True):
        before = read_launches()
        if plain:
            rasterizer_cuda.raster_tile = raster_tile_plain
            for blk in extractor.model.blocks:
                blk.attn.attention_fn = dense_attention
        try:
            img = rasterizer_cuda.raster_tile(rows_, slots, SMOOTH_RES, SMOOTH_TILE, settings.ambient, False)
            conf = refiner.pose_confidence_batch(mesh, staged[chunk], k, chunk_poses, fetch=False,
                                                 channels_last=True)
            crops_renders = torch.cat([torch.stack([refiner._crop_and_k(
                staged[i].permute(2, 0, 1).float() / 255.0, pts, kd, pd[j])[0] for j, i in enumerate(chunk.tolist())]),
                img[..., 1:4].permute(0, 3, 1, 2)])
            feats = normalize_feats(feature_fn(crops_renders).float())
        finally:
            rasterizer_cuda.raster_tile = raster_tile
            for blk in extractor.model.blocks:
                blk.attn.attention_fn = flash_attention_fn
        after = read_launches()
        runs[plain] = dict(img=img, conf=conf, feats=feats,
                           launches={key: after[key] - before[key] for key in ("K1", "K2")})
    img_k, img_p = runs[False]["img"], runs[True]["img"]
    mask_mismatch = int(((img_k[..., 0] > 0) != (img_p[..., 0] > 0)).sum())
    depth_err = float((img_k[..., 0] - img_p[..., 0]).abs().max())
    feature_cos_min = float((runs[False]["feats"] * runs[True]["feats"]).sum(-1).min())
    confs = {plain: runs[plain]["conf"].cpu() for plain in runs}
    inliers_chunk = {("plain" if plain else "kernels"): (c > float(quantile_threshold(c))).sum(dim=(1, 2)).tolist()
                     for plain, c in confs.items()}
    chunk_launches = {"kernels": runs[False]["launches"], "plain": runs[True]["launches"]}
    del runs, img_k, img_p

    # K1 at 518², tile 37 on that chunk, against its plain version; the gate
    # must fail a kernel that reads a slot from the next pose's rows.
    def k1_check(out, ref):
        return (int(((out[..., 0] > 0) != (ref[..., 0] > 0)).sum()), float((out[..., 0] - ref[..., 0]).abs().max()),
                float((out[..., 1:] - ref[..., 1:]).abs().max()))

    k1_ref = raster_tile_plain(rows_, slots, SMOOTH_RES, SMOOTH_TILE, settings.ambient, False)
    k1 = k1_check(raster_tile(rows_, slots, SMOOTH_RES, SMOOTH_TILE, settings.ambient, False), k1_ref)
    k1_wrong = k1_check(reads_next_pose(rows_, slots, SMOOTH_RES, SMOOTH_TILE, settings.ambient, False), k1_ref)
    k1_ms = cuda_ms(lambda: raster_tile(rows_, slots, SMOOTH_RES, SMOOTH_TILE, settings.ambient, False), reps=10)
    k1_device = device_ms(lambda: raster_tile(rows_, slots, SMOOTH_RES, SMOOTH_TILE, settings.ambient, False))
    k1_plain_ms = cuda_ms(lambda: raster_tile_plain(rows_, slots, SMOOTH_RES, SMOOTH_TILE, settings.ambient, False),
                          reps=1)
    kb = k1_bound(rows_, slots, SMOOTH_RES, SMOOTH_TILE, False)
    k1_line = {"poses": rows_.shape[0], "tiles": slots.shape[1], "faces_per_tile": slots.shape[2],
               "hit_mask_mismatches": k1[0], "depth_max_err": k1[1], "rgb_max_err": k1[2], "atol": K1_ATOL,
               "reads_next_pose": {"hit_mask_mismatches": k1_wrong[0], "depth_max_err": k1_wrong[1],
                                   "rgb_max_err": k1_wrong[2]},
               "ms": k1_ms, "device_ms": k1_device, "plain_ms": k1_plain_ms, "bound_ms": kb["bound_ms"],
               "bound_by": kb["bound_by"], "faces_held": kb["faces_held"],
               "hit_px": int((k1_ref[..., 0] > 0).sum())}
    del k1_ref, rows_, slots

    # K2 at DINOv2-B's confidence-chunk shape against its plain version.
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    b, heads, ntok, d = 2 * SMOOTH_CHUNK, VIT_B14_REG.num_heads, 1 + 4 + (RES // 14) ** 2, 64
    q, kk, v = (torch.randn((b, heads, ntok, d), generator=gen, device=dev) for _ in range(3))
    q, kk, v = (q * QUERY_STD).to(torch.bfloat16), kk.to(torch.bfloat16), v.to(torch.bfloat16)
    scale = d ** -0.5
    ref = dense_attention(q, kk, v, scale)
    k2 = check_attention(flash_attention_k2(q, kk, v, scale), ref, bf16_error_bound(q, kk, v, scale, ref), {
        "drops_last_keys": dense_attention(q, kk[:, :, :-DROPPED_KEYS], v[:, :, :-DROPPED_KEYS], scale),
        "reads_next_head": reads_next_head(q, kk, v, scale, sm90_key_tile(d))})
    k2_bound, k2_bound_by = bound(4 * b * heads * ntok * ntok * d, 4 * b * heads * ntok * d * 2)
    k2_line = {"shape": [b, heads, ntok, d], **k2, "tol": ATTN_TOL,
               "ms": cuda_ms(lambda: flash_attention_k2(q, kk, v, scale), reps=10),
               "device_ms": device_ms(lambda: flash_attention_k2(q, kk, v, scale)),
               "plain_ms": cuda_ms(lambda: dense_attention(q, kk, v, scale), reps=3),
               "sdpa_ms": cuda_ms(lambda: F.scaled_dot_product_attention(q, kk, v, scale=scale), reps=10),
               "sdpa_device_ms": device_ms(lambda: F.scaled_dot_product_attention(q, kk, v, scale=scale)),
               "bound_ms": k2_bound, "bound_by": k2_bound_by}
    del q, kk, v, ref

    result = dict(frames=n, frames_by_track=frames_of, kept_track=kept[0]["track_id"], coarse_rows=len(coarse),
                  rows=row_checks,
                  cli_s=cli_s, coarse_cli_s=coarse_s, weights_write_s=weights_s, launches=launches,
                  launches_by_tracker=tracker_launches, coarse_cli_launches=coarse_launches,
                  cli_last_lines=cli_out.getvalue().strip().splitlines()[-3:], inliers=inliers.tolist(),
                  start_frame=best, valid_correspondences=int(valid.sum()),
                  confidence_ms_per_frame=conf_ms / n, correspondences_ms_per_interval=corr_ms,
                  tracker_ms_per_interval={name: t["ms"] for name, t in trackers.items()}, trackers=trackers,
                  epnp_ms_per_interval=pnp_ms, smoothing_ms=smooth_ms,
                  chunk_kernel_vs_plain={"render_mask_mismatches": mask_mismatch, "depth_max_err": depth_err,
                                         "depth_atol": K1_ATOL, "feature_cos_min": feature_cos_min,
                                         "feature_cos_floor": FEATURE_COS_MIN, "inliers": inliers_chunk,
                                         "launches": chunk_launches},
                  k1_518=k1_line, k2_b16_1374=k2_line,
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, profile=profile)
    log("smooth", **result)
    if min(min(c.values()) for c in tracker_launches.values()) <= 0:
        raise AssertionError(f"a smooth_poses_video run did not launch K1 and K2 at d 64: {tracker_launches}")
    for name, c in row_checks.items():
        if c["rows"] != n_frames or not c["frames"] or c["rot_orth_err"] > SMOOTH_ORTH_ATOL \
                or not c["t_finite"] or c["t_z_min"] <= 0:
            raise AssertionError(f"smooth path, {name}: {c}")
    if mask_mismatch or depth_err > K1_ATOL or feature_cos_min < FEATURE_COS_MIN:
        raise AssertionError(f"confidence chunk, kernels vs plain versions: {result['chunk_kernel_vs_plain']}")
    if min(chunk_launches["kernels"].values()) <= 0 or max(chunk_launches["plain"].values()) != 0:
        raise AssertionError(f"confidence chunk, kernels vs plain versions: launches {chunk_launches}")
    if k1[0] or max(k1[1:]) > K1_ATOL or not (k1_wrong[0] > 0 or max(k1_wrong[1:]) > K1_ATOL):
        raise AssertionError(f"K1 at {SMOOTH_RES}², tile {SMOOTH_TILE}: {k1_line}")
    return result, launches

# Proposals path: a BOP-layout test split of LM-O / YCB-V sized images, the
# box threshold's count on image 0, the floor of the mean mask IoU of SAM2
# image masks kernels vs plain (the video phase's), and of the cosine of each
# proposal's retrieval feature K2 vs plain (bf16 DINOv2-L to layer 22).
PROPOSAL_IMAGES, PROPOSAL_HW, PROPOSAL_OBJECTS, PROPOSAL_BOXES = 3, (480, 640), 5, 16
LMO_K = [572.4114, 0.0, 325.2611, 0.0, 573.57043, 242.04899, 0.0, 0.0, 1.0]  # LM-O's camera
FEATURE_COS_MIN = 0.99


def bop_test_split(root: Path, seed: int = SEED) -> list:
    """A seeded BOP-layout test split under `root` (scene 000001): PROPOSAL_IMAGES
    RGB images of PROPOSAL_HW, PROPOSAL_OBJECTS painted ellipses and boxes
    on a blocky noisy background each, with scene_camera.json (LM-O's
    intrinsics) and scene_gt.json. Returns the images."""
    from PIL import Image

    rng = np.random.default_rng(seed + 5)
    h, w = PROPOSAL_HW
    scene = root / "test" / "000001"
    (scene / "rgb").mkdir(parents=True)
    yy, xx = np.mgrid[:h, :w]
    bg = np.kron(rng.random((12, 16, 3)), np.ones((h // 12, w // 16, 1))) * 110
    images, cams, gts = [], {}, {}
    for fid in range(PROPOSAL_IMAGES):
        img = bg + rng.random((h, w, 3)) * 40
        gts[str(fid)] = []
        for obj in range(PROPOSAL_OBJECTS):
            cy, cx = rng.uniform(0.2, 0.8) * h, rng.uniform(0.15, 0.85) * w
            ry, rx = rng.uniform(30, 90), rng.uniform(30, 110)
            inside = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1) if obj % 2 else \
                ((abs(yy - cy) <= ry) & (abs(xx - cx) <= rx))
            img[inside] = rng.uniform(60, 255, 3)
            gts[str(fid)].append({"obj_id": obj + 1, "cam_R_m2c": np.eye(3).ravel().tolist(),
                                  "cam_t_m2c": [0.0, 0.0, 800.0]})
        images.append(img.clip(0, 255).astype(np.uint8))
        Image.fromarray(images[-1]).save(scene / "rgb" / f"{fid:06d}.png", compress_level=1)
        cams[str(fid)] = {"cam_K": LMO_K, "depth_scale": 1.0}
    (scene / "scene_camera.json").write_text(json.dumps(cams))
    (scene / "scene_gt.json").write_text(json.dumps(gts))
    return images


def phase_proposals(dev) -> tuple[dict, dict]:
    """The static proposal path at full width through its CLIs: the
    retrieval bank's features (extract_retrieval_features on the refine
    phase's 600-view template shards, then merge_features), then
    extract_proposals_ground --detector grounding (GroundingDINO-B at 800²,
    SAM2 Hiera-L at 1024², DINOv2-L layer 22, all bf16, --topk 0) on a seeded
    3-image BOP split against the video phase's 46,000 x 1024 bank, from
    .npz files of seeded weights in the JAX layout.

    With random weights the detection scores are arbitrary, so --box-threshold
    is taken halfway between the PROPOSAL_BOXES-th and the next sigmoid score
    of a first `detect` on image 0: about 16 boxes per image, which sizes
    the work (a batched 16-box SAM2 prompt set and a 16-crop retrieval) and
    hides nothing. Neither package clips a detector box to the image, and a
    box of random weights may reach past its border: the box gate asks for
    finite boxes of positive size whose centre lies in the image (the
    detector's sigmoid boxes guarantee no more)."""
    import contextlib
    import io

    from freepose_tpu_torch.models.convert import (random_grounding_dino_params, random_sam2_image_params,
                                                   save_params)
    from freepose_tpu_torch.models import grounding_dino as gdm
    from freepose_tpu_torch.models.sam2.model import Sam2Config
    from freepose_tpu_torch.ops import attention
    from freepose_tpu_torch.ops.attention import dense_attention, flash_attention_fn
    from freepose_tpu_torch.io.proposals_json import proposal_mask
    from freepose_tpu_torch.pipeline.proposals import retrieve_topk
    from freepose_tpu_torch.scripts import extract_proposals_ground, extract_retrieval_features, merge_features
    from freepose_tpu_torch.scripts.common import (load_dino_extractor, load_filelist, load_grounding_detector,
                                                   load_sam2_image_predictor, release_models)

    bop = WORK_DIR / "bop" / "smoke"
    images = bop_test_split(bop)
    t0 = time.perf_counter()
    save_params(random_grounding_dino_params(gdm.GroundingDinoConfig(), seed=SEED), WORK_DIR / "gdino.npz")
    save_params(random_sam2_image_params(Sam2Config(), seed=SEED), WORK_DIR / "sam2_image.npz")
    weights_s = time.perf_counter() - t0
    gd, sam, dino = (str(WORK_DIR / f) for f in ("gdino.npz", "sam2_image.npz", "dinov2.npz"))
    detector = load_grounding_detector(gd, dev)
    _, scores0 = detector.detect(images[0], box_threshold=-1.0)
    ranked = np.sort(scores0)[::-1]
    threshold = float((ranked[PROPOSAL_BOXES - 1] + ranked[PROPOSAL_BOXES]) / 2)
    mesh_names = load_filelist(WORK_DIR / "refine_meshes.txt")
    names = load_filelist(WORK_DIR / "filelist.txt")

    # The path, once, through the CLIs a user calls.
    torch.cuda.synchronize()
    reset_launches()
    cli_out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(cli_out):
        extract_retrieval_features.main(["--wds-dir", str(WORK_DIR / "shards"), "--filelist",
                                         str(WORK_DIR / "refine_meshes.txt"), "--out", str(WORK_DIR / "feats"),
                                         "--weights", dino, "--layer", str(DINO_LAYER), "--device", str(dev)])
    torch.cuda.synchronize()
    features_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(cli_out):
        merge_features.main(["--features-dir", str(WORK_DIR / "feats"), "--filelist",
                             str(WORK_DIR / "refine_meshes.txt"), "--out", str(WORK_DIR / "bank_refine.npy")])
    merge_s = time.perf_counter() - t0
    bank_launches = read_launches()
    argv = ["--dataset", str(bop), "--bank", str(WORK_DIR / "bank.npy"), "--filelist", str(WORK_DIR / "filelist.txt"),
            "--out-dir", str(WORK_DIR), "--detector", "grounding", "--box-threshold", repr(threshold),
            "--grounding-weights", gd, "--sam2-weights", sam, "--weights", dino, "--layer", str(DINO_LAYER),
            "--device", str(dev)]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(cli_out):
        extract_proposals_ground.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = read_launches()
    view_feats = np.load(WORK_DIR / "feats" / f"{mesh_names[0].replace('_', '')}.npy")
    bank_refine = np.load(WORK_DIR / "bank_refine.npy")
    (out_json,) = WORK_DIR.glob("props-ground-*.json")
    props = json.loads(out_json.read_text())

    # The same functions, measured per image: detection, SAM2 on its boxes,
    # retrieval of the masks the CLI keeps.
    predictor = load_sam2_image_predictor(sam, dev)
    extractor = load_dino_extractor(dino, device=dev)
    bank = np.load(WORK_DIR / "bank.npy")
    bank_dev = torch.as_tensor(bank / np.maximum(np.linalg.norm(bank, axis=-1, keepdims=True), 1e-12), device=dev)
    del bank
    det_ms, sam_ms, ret_ms, box_counts, kept = [], [], [], [], []
    per_image = []
    for img in images:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        boxes, _ = detector.detect(img, box_threshold=threshold)
        det_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        predictor.set_image(img)
        masks, _, _ = predictor.predict(box=boxes, multimask_output=False, fetch_low_res_logits=False)
        sam_ms.append((time.perf_counter() - t0) * 1e3)
        keep = masks[:, 0].sum(axis=(1, 2)) >= MIN_MASK_PX
        box_counts.append(len(boxes))
        kept.append(int(keep.sum()))
        per_image.append((img, boxes, masks[:, 0]))
        t0 = time.perf_counter()
        if keep.any():
            retrieve_topk(img, masks[keep, 0], torch.as_tensor(boxes[keep]), bank_dev, extractor, DINO_LAYER, k=100)
        torch.cuda.synchronize()
        ret_ms.append((time.perf_counter() - t0) * 1e3)
    profile = profile_device_time(lambda: detector.forward_images([images[0]]), "gdino_forward", top=16)
    profile["gdino_forward"]["by_module_ms"] = module_device_ms(
        lambda: detector.forward_images([images[0]]),
        {"deformable_attention": gdm.MultiScaleDeformableAttention, "swin": gdm.SwinBackbone, "bert": gdm.Bert,
         "fusion": gdm.BiMultiHeadAttention})

    def sam2_step():
        predictor.set_image(images[0])
        predictor.predict(box=per_image[0][1], multimask_output=False, fetch_low_res_logits=False)

    profile.update(profile_device_time(sam2_step, "sam2_image", top=8))

    # The same image twice: the same boxes (the query selection's tie order).
    again = [detector.detect(images[0], box_threshold=threshold) for _ in range(2)]
    repeat_identical = all(np.array_equal(a, b) for a, b in zip(*again))

    # SAM2 masks on image 0's boxes, then retrieval features of the kernel
    # run's masks (the same crops for both), each with the kernels and with
    # every attention call on its plain version.
    img, boxes, _ = per_image[0]
    runs = {}
    for plain in (False, True):
        before = read_launches()
        kernel_auto = attention.flash_attention_auto
        if plain:
            attention.flash_attention_auto = plain_attention_auto
            for blk in extractor.model.blocks:
                blk.attn.attention_fn = dense_attention
        try:
            predictor.set_image(img)
            masks, _, low = predictor.predict(box=boxes, multimask_output=False)
            keep = runs[False]["keep"] if plain else masks[:, 0].sum(axis=(1, 2)) >= MIN_MASK_PX
            crops = runs[False]["masks"][keep] if plain else masks[keep, 0]
            _, _, feats = retrieve_topk(img, crops, torch.as_tensor(boxes[keep]), bank_dev, extractor, DINO_LAYER,
                                        k=100)
        finally:
            attention.flash_attention_auto = kernel_auto
            for blk in extractor.model.blocks:
                blk.attn.attention_fn = flash_attention_fn
        after = read_launches()
        runs[plain] = dict(masks=masks[:, 0], low=low, keep=keep, feats=feats.float(),
                           launches={str(d): after["K2_by_dim"].get(str(d), 0) - before["K2_by_dim"].get(str(d), 0)
                                     for d in (64, 72)})
    inter = (runs[False]["masks"] & runs[True]["masks"]).sum(axis=(1, 2))
    union = (runs[False]["masks"] | runs[True]["masks"]).sum(axis=(1, 2))
    ious = np.where(union > 0, inter / np.maximum(union, 1), 1.0)
    cos = (runs[False]["feats"] * runs[True]["feats"]).sum(-1).cpu().numpy()
    kernel_vs_plain = {"sam2_mask_iou_mean": float(ious.mean()), "sam2_mask_iou_min": float(ious.min()),
                       "sam2_mask_ious": [float(x) for x in ious],
                       "low_res_logit_max_abs_diff": float(np.abs(runs[False]["low"] - runs[True]["low"]).max()),
                       "low_res_logit_max_abs": float(np.abs(runs[True]["low"]).max()),
                       "feature_cos_min": float(cos.min()), "features_compared": len(cos),
                       "launches": {"kernels": runs[False]["launches"], "plain": runs[True]["launches"]}}
    del runs, extractor, predictor, detector, bank_dev
    release_models()

    h, w = PROPOSAL_HW
    per_image_props = [sum(p["image_id"] == f for p in props) for f in range(PROPOSAL_IMAGES)]
    boxes_ok = all(all(math.isfinite(v) for v in p["bbox"]) and p["bbox"][2] > 0 and p["bbox"][3] > 0
                   and 0 <= p["bbox"][0] + p["bbox"][2] / 2 <= w and 0 <= p["bbox"][1] + p["bbox"][3] / 2 <= h
                   for p in props)
    boxes_inside = sum(p["bbox"][0] >= 0 and p["bbox"][1] >= 0 and p["bbox"][0] + p["bbox"][2] <= w
                       and p["bbox"][1] + p["bbox"][3] <= h for p in props)
    mask_px = [int(proposal_mask(p).sum()) for p in props]
    meshes_known = all(p["mesh"] in set(names) for p in props)
    k2 = {str(d): launches["K2_by_dim"].get(str(d), 0) for d in (64, 72)}
    result = dict(images=PROPOSAL_IMAGES, image_hw=list(PROPOSAL_HW), bank_rows=len(names),
                  box_threshold=threshold, boxes_per_image=box_counts, masks_kept_per_image=kept,
                  proposals=len(props), proposals_per_image=per_image_props, boxes_fully_inside=boxes_inside,
                  mask_px_min=min(mask_px, default=0), meshes_chosen=len({p["mesh"] for p in props}),
                  cli_s=cli_s, cli_last_line=cli_out.getvalue().strip().splitlines()[-1],
                  bank_features_s=features_s, bank_meshes=len(mesh_names),
                  bank_features_s_per_mesh=features_s / len(mesh_names), merge_features_s=merge_s,
                  view_features_shape=list(view_feats.shape), bank_refine_shape=list(bank_refine.shape),
                  weights_write_s=weights_s, detect_ms_per_image=det_ms, sam2_ms_per_image=sam_ms,
                  retrieval_ms_per_image=ret_ms, detect_repeat_identical=repeat_identical,
                  kernel_vs_plain=kernel_vs_plain, k2_launches_by_dim=k2,
                  bank_k2_launches_by_dim={str(d): bank_launches["K2_by_dim"].get(str(d), 0) for d in (64, 72)},
                  launches=launches, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, profile=profile)
    log("proposals", **result)
    if min(k2.values()) <= 0 or launches["launches_by_kernel"]["sm90"] <= 0:
        raise AssertionError(f"proposals path did not launch K2 at d 64 and d 72: {launches}")
    if min(per_image_props) < 1:
        raise AssertionError(f"an image without a proposal: {per_image_props}")
    if not boxes_ok or min(mask_px, default=0) <= 0 or not meshes_known:
        raise AssertionError(f"proposals: boxes ok {boxes_ok}, least mask {min(mask_px, default=0)} px, "
                             f"meshes in the filelist {meshes_known}")
    if view_feats.shape != (N_VIEWS, BANK_DIM) or not np.isfinite(view_feats).all() \
            or bank_refine.shape != (len(mesh_names), BANK_DIM):
        raise AssertionError(f"bank features {view_feats.shape}, bank {bank_refine.shape}")
    if not repeat_identical:
        raise AssertionError("detect on the same image twice gave different boxes")
    if kernel_vs_plain["sam2_mask_iou_mean"] < VIDEO_IOU_MIN or kernel_vs_plain["feature_cos_min"] < FEATURE_COS_MIN:
        raise AssertionError(f"proposals, kernels vs plain versions: {kernel_vs_plain}")
    if min(kernel_vs_plain["launches"]["kernels"].values()) <= 0 or \
            max(kernel_vs_plain["launches"]["plain"].values()) != 0:
        raise AssertionError(f"proposals, kernels vs plain versions: launches {kernel_vs_plain['launches']}")
    return result, launches


# Evaluation path: a seeded BOP test split at 640x480 with LM-O's
# intrinsics, two instances of the torus (GT half-extent EVAL_HALF) per
# image and four estimates of the first, every BOP error. MaskRenderer
# renders one pose per call at max(w, h) = 640, tile 32, depth only.
EVAL_IMAGES, EVAL_HALF, EVAL_SHIFT = 3, 0.06, 0.05
EVAL_ERRORS = ("cus", "chamfer", "chamfer_proj", "mssd", "mspd", "vsd")
# VSD with K1 vs the plain rasterizer: depth within K1_ATOL can move a
# pixel across the visibility threshold delta or a step cost's tau, each
# such pixel 1 / (union) of the error: per pair within EVAL_VSD_ATOL,
# AR_vsd (a mean of recalls over 10 taus x 10 thresholds) within
# EVAL_AR_VSD_ATOL.
EVAL_VSD_ATOL = 1e-3
EVAL_AR_VSD_ATOL = 0.02


def write_ply(mesh, path: Path) -> None:
    """Binary little-endian PLY of a mesh's vertices and faces (the BOP
    model format)."""
    header = (f"ply\nformat binary_little_endian 1.0\nelement vertex {mesh.num_vertices}\n"
              "property float x\nproperty float y\nproperty float z\n"
              f"element face {mesh.num_faces}\nproperty list uchar int vertex_indices\nend_header\n")
    faces = np.zeros(mesh.num_faces, dtype=[("n", "u1"), ("i", "<i4", 3)])
    faces["n"], faces["i"] = 3, mesh.faces
    path.write_bytes(header.encode() + np.asarray(mesh.vertices, "<f4").tobytes() + faces.tobytes())


def eval_scene(root: Path, mesh, dev, seed: int = SEED) -> dict:
    """A seeded BOP test split under root/bop (scene 000001, like
    bop_test_split): EVAL_IMAGES RGB images of PROPOSAL_HW with LM-O's
    intrinsics, two instances of obj 1 (`mesh` at half-extent EVAL_HALF,
    models/obj_000001.ply in mm) per image, depth PNGs rendered at the GT
    poses (BOP 0.1 mm units), scene_gt.json, scene_gt_info.json with
    visib_fract; the unit mesh as the inference mesh (inference/smoke_torus.ply)
    and a results CSV of 4 estimates of instance 0 per image (the GT pose,
    5° and 30° off about a seeded axis, shifted EVAL_SHIFT m along x), the
    estimate's scale EVAL_HALF. Returns the GT and estimate poses."""
    from PIL import Image
    from scipy.spatial.transform import Rotation

    from freepose_tpu_torch.evaluation.pose_error import MaskRenderer
    from freepose_tpu_torch.io.bop_csv import PoseResult, write_results_csv

    def rot_about(axis, deg):
        return Rotation.from_rotvec(np.radians(deg) * axis / np.linalg.norm(axis)).as_matrix()

    rng = np.random.default_rng(seed + 9)
    h, w = PROPOSAL_HW
    k = np.asarray(LMO_K).reshape(3, 3)
    scene = root / "bop" / "test" / "000001"
    for sub in ("rgb", "depth"):
        (scene / sub).mkdir(parents=True)
    (root / "models").mkdir()
    (root / "inference").mkdir()
    write_ply(mesh.scaled(EVAL_HALF * 1000.0), root / "models" / "obj_000001.ply")
    write_ply(mesh, root / "inference" / "smoke_torus.ply")
    renderer = MaskRenderer(w, h, backend="device", device=dev)
    renderer.add_object("gt", mesh.scaled(EVAL_HALF))
    cams, gts, infos, results, truth = {}, {}, {}, [], []
    for fid in range(EVAL_IMAGES):
        poses = []
        for x, y, z in ((-0.08, -0.02, 0.7), (0.12, 0.05, 0.8)):
            r = rot_about(rng.normal(size=3), rng.uniform(0, 180))
            poses.append((r, np.array([x, y, z]) + rng.uniform(-0.02, 0.02, 3)))
        depths = [renderer.render_depth("gt", r, t, k).cpu().numpy() for r, t in poses]
        z = np.where(np.stack(depths) > 0, np.stack(depths), np.inf).min(axis=0)
        scene_depth = np.where(np.isfinite(z), z, 0.0)
        Image.fromarray(np.round(scene_depth * 10000).astype(np.uint16)).save(scene / "depth" / f"{fid:06d}.png")
        img = (rng.random((h, w, 3)) * 60 + np.where(scene_depth[..., None] > 0, 150, 40)).astype(np.uint8)
        Image.fromarray(img).save(scene / "rgb" / f"{fid:06d}.png", compress_level=1)
        cams[str(fid)] = {"cam_K": LMO_K, "depth_scale": 0.1}
        gts[str(fid)] = [{"obj_id": 1, "cam_R_m2c": r.ravel().tolist(), "cam_t_m2c": (t * 1000.0).tolist()}
                         for r, t in poses]
        infos[str(fid)] = [{"visib_fract": float(((d > 0) & (d <= z)).sum() / max((d > 0).sum(), 1))} for d in depths]
        r0, t0 = poses[0]
        axis = rng.normal(size=3)
        ests = {"gt": (r0, t0), "rot5": (rot_about(axis, 5.0) @ r0, t0), "rot30": (rot_about(axis, 30.0) @ r0, t0),
                "shift": (r0, t0 + np.array([EVAL_SHIFT, 0.0, 0.0]))}
        scores = rng.permutation(len(ests)) * 0.1 + 0.5  # a different order of confidence per image
        for (name, (r, t)), score in zip(ests.items(), scores):
            results.append(PoseResult(1, fid, "smoke_torus", float(score), r, t, scale=EVAL_HALF, time=0.1))
        truth.append({"gt": poses, "est": ests})
    (scene / "scene_camera.json").write_text(json.dumps(cams))
    (scene / "scene_gt.json").write_text(json.dumps(gts))
    (scene / "scene_gt_info.json").write_text(json.dumps(infos))
    write_results_csv(results, root / "est.csv", t_scale=1000.0)
    return {"k": k, "poses": truth, "renderer": renderer}


def drops_first_slot(slots: torch.Tensor) -> torch.Tensor:
    """Slots of a wrong K1 that skips each tile's first held face (its
    candidates are packed first, so that is slot 0)."""
    wrong = slots.clone()
    wrong[..., 0] = -1
    return wrong


def phase_eval(dev, mesh) -> tuple[dict, dict]:
    """The BOP evaluation path at full width through its CLI: eval_bop_pose
    --errors cus chamfer chamfer_proj mssd mspd vsd on eval_scene, once with
    the MaskRenderer on K1 and once on the plain rasterizer (backend "xla");
    then K1 at the evaluation shape (one pose at 640², tile 32, 256 faces
    per tile, depth only) against its plain version, timed with its
    prologue by part."""
    import contextlib
    import dataclasses
    import io

    from freepose_tpu_torch.evaluation import pose_error as pe
    from freepose_tpu_torch.io.mesh import pad_mesh
    from freepose_tpu_torch.ops.rasterizer import rasterize
    from freepose_tpu_torch.ops.rasterizer_cuda import (bin_faces, face_rows, project_faces, raster_tile,
                                                         raster_tile_plain)
    from freepose_tpu_torch.scripts import eval_bop_pose

    root = WORK_DIR / "eval"
    t0 = time.perf_counter()
    scene = eval_scene(root, mesh, dev)
    scene_s = time.perf_counter() - t0
    k = scene["k"]

    def plain_rasterize(*args):
        *rest, settings = args
        return rasterize(*rest, dataclasses.replace(settings, backend="xla"))

    render_depth, vsd, cus = pe.MaskRenderer.render_depth, pe.vsd, pe.cus
    runs = {}
    for plain in (False, True):
        rec = {"renders": 0, "vsd": [], "cus": []}

        def counted(self, *a, **kw):
            rec["renders"] += 1
            return render_depth(self, *a, **kw)

        def vsd_rec(*a, **kw):
            out = vsd(*a, **kw)
            rec["vsd"].append(out)
            return out

        def cus_rec(r_est, t_est, r_gt, t_gt, *a, **kw):
            out = cus(r_est, t_est, r_gt, t_gt, *a, **kw)
            rec["cus"].append((np.asarray(r_est), np.asarray(t_est), np.asarray(t_gt), out))
            return out

        argv = ["--results", str(root / "est.csv"), "--dataset", str(root / "bop"), "--models-dir",
                str(root / "models"), "--inference-mesh-dir", str(root / "inference"), "--errors", *EVAL_ERRORS,
                "--out", str(root / f"scores_{'plain' if plain else 'k1'}.json"), "--device", str(dev)]
        pe.MaskRenderer.render_depth, pe.vsd, pe.cus = counted, vsd_rec, cus_rec
        if plain:
            pe.rasterize = plain_rasterize
        try:
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                scores = eval_bop_pose.main(argv)
            torch.cuda.synchronize()
            rec["cli_s"] = time.perf_counter() - t0
            rec["launches"] = read_launches()
        finally:
            pe.MaskRenderer.render_depth, pe.vsd, pe.cus, pe.rasterize = render_depth, vsd, cus, rasterize
        rec["scores"] = scores
        runs["plain" if plain else "k1"] = rec
    k1, plain = runs["k1"], runs["plain"]
    launches = k1["launches"]

    # The estimates' cus against instance 0: the GT pose's and the 30° one's.
    def cus_of(name):
        vals = []
        for r_est, t_est, t_gt, val in k1["cus"]:
            for truth in scene["poses"]:
                r, t = truth["est"][name]
                if np.allclose(r_est, r, atol=1e-5) and np.allclose(t_est, t, atol=1e-5) and \
                        np.allclose(t_gt, truth["gt"][0][1], atol=1e-5):
                    vals.append(val)
        return vals

    cus_gt, cus_30 = cus_of("gt"), cus_of("rot30")
    cus_diff = [i for i, (a, b) in enumerate(zip(k1["cus"], plain["cus"])) if a[3] != b[3]]
    vsd_diff = max(float(np.abs(np.subtract(a, b)).max()) for a, b in zip(k1["vsd"], plain["vsd"]))

    # K1 at the evaluation shape: instance 0 of image 0, as the CLI renders it.
    renderer = scene["renderer"]
    settings = renderer.settings
    r0, t0_ = scene["poses"][0]["gt"][0]
    v, c, f, valid = (torch.as_tensor(a, device=dev)
                      for a in pad_mesh(mesh.scaled(EVAL_HALF), renderer.max_vertices, renderer.max_faces))
    pose = torch.eye(4, device=dev)
    pose[:3, :3] = torch.as_tensor(r0, dtype=torch.float32, device=dev)
    pose[:3, 3] = torch.as_tensor(t0_, dtype=torch.float32, device=dev)
    poses = pose[None]
    ks = torch.as_tensor(k, dtype=torch.float32, device=dev).expand(1, 3, 3)
    res, tile = settings.resolution, settings.tile
    tri_uv, tri_z, fvalid = project_faces(v, f, valid, poses, ks, settings)
    prologue_ms = {"projection": cuda_ms(lambda: project_faces(v, f, valid, poses, ks, settings), reps=20),
                   "binning": cuda_ms(lambda: bin_faces(tri_uv, fvalid, settings), reps=20),
                   "face_rows": cuda_ms(lambda: face_rows(tri_uv, tri_z, c, f, settings), reps=20)}
    rows, slots = face_rows(tri_uv, tri_z, c, f, settings), bin_faces(tri_uv, fvalid, settings)
    out = raster_tile(rows, slots, res, tile, settings.ambient, True)
    ref = raster_tile_plain(rows, slots, res, tile, settings.ambient, True)
    mismatch = int(((out[..., 0] > 0) != (ref[..., 0] > 0)).sum())
    depth_err = float((out[..., 0] - ref[..., 0]).abs().max())
    hit_px = int((out[..., 0] > 0).sum())
    wrong = raster_tile_plain(rows, drops_first_slot(slots), res, tile, settings.ambient, True)
    wrong_check = {"hit_mask_mismatches": int(((wrong[..., 0] > 0) != (ref[..., 0] > 0)).sum()),
                   "depth_max_err": float((wrong[..., 0] - ref[..., 0]).abs().max())}
    kernel_ms = cuda_ms(lambda: raster_tile(rows, slots, res, tile, settings.ambient, True), reps=50)
    kernel_device = device_ms(lambda: raster_tile(rows, slots, res, tile, settings.ambient, True), reps=20)
    kernel_plain_ms = cuda_ms(lambda: raster_tile_plain(rows, slots, res, tile, settings.ambient, True), reps=3)
    render_ms = cuda_ms(lambda: renderer.render_depth("gt", r0, t0_, k), reps=20)
    render_plain_ms = cuda_ms(lambda: plain_rasterize(v, c, f, valid, poses, ks[0], settings), reps=3)
    kb = k1_bound(rows, slots, res, tile, True)
    k1_eval = dict(resolution=res, tile=tile, faces_per_tile=slots.shape[2], faces=rows.shape[1], hit_px=hit_px,
                   hit_mask_mismatches=mismatch, depth_max_err=depth_err, atol=K1_ATOL,
                   drops_first_slot=wrong_check, prologue_ms=prologue_ms,
                   prologue_total_ms=sum(prologue_ms.values()), ms=kernel_ms, device=kernel_device,
                   plain_ms=kernel_plain_ms, render_ms=render_ms, render_plain_ms=render_plain_ms,
                   **kb, bound_share=kb["bound_ms"] / kernel_device if kernel_device else None)
    del rows, slots, out, ref, wrong, tri_uv, tri_z, fvalid

    ar = {key: (k1["scores"][key], plain["scores"][key]) for key in k1["scores"] if key.startswith("AR")}
    result = dict(images=EVAL_IMAGES, image_hw=list(PROPOSAL_HW), errors=list(EVAL_ERRORS), scene_s=scene_s,
                  cli_s=k1["cli_s"], cli_plain_s=plain["cli_s"], renders_per_run=k1["renders"],
                  renders_per_run_plain=plain["renders"], ms_per_render_cli=k1["cli_s"] * 1e3 / k1["renders"],
                  ar_k1_vs_plain=ar, vsd_pairs=len(k1["vsd"]), vsd_max_abs_diff=vsd_diff,
                  vsd_atol=EVAL_VSD_ATOL, cus_pairs=len(k1["cus"]), cus_pairs_differing=len(cus_diff),
                  cus_gt_estimate=cus_gt, cus_30deg_estimate=cus_30,
                  launches=launches, plain_run_k1_launches=plain["launches"]["K1"], k1=k1_eval,
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log("eval", **result)
    if launches["K1"] <= 0 or plain["launches"]["K1"] != 0:
        raise AssertionError(f"eval path: K1 launches {launches['K1']} on K1, {plain['launches']['K1']} on plain")
    if k1["renders"] != plain["renders"] or k1["renders"] != launches["K1"]:
        raise AssertionError(f"eval path: {k1['renders']} renders, {plain['renders']} plain, K1 {launches['K1']}")
    if len(k1["cus"]) != len(plain["cus"]) or cus_diff:
        raise AssertionError(f"eval path, K1 vs plain rasterizer: cus differs on pairs {cus_diff}")
    for key in ("AR_cus", "AR_chamfer", "AR_chamfer_proj", "AR_mssd", "AR_mspd"):
        if ar[key][0] != ar[key][1]:
            raise AssertionError(f"eval path, K1 vs plain rasterizer: {key} {ar[key]}")
    if len(k1["vsd"]) != len(plain["vsd"]) or vsd_diff > EVAL_VSD_ATOL or \
            abs(ar["AR_vsd"][0] - ar["AR_vsd"][1]) > EVAL_AR_VSD_ATOL:
        raise AssertionError(f"eval path, K1 vs plain rasterizer: vsd max diff {vsd_diff}, AR_vsd {ar['AR_vsd']}")
    if len(cus_gt) != EVAL_IMAGES or len(cus_30) != EVAL_IMAGES or max(cus_gt) >= 0.01 or min(cus_30) <= 0.1:
        raise AssertionError(f"eval path: cus of the GT estimate {cus_gt}, of the 30° one {cus_30}")
    if not 0.0 < ar["AR"][0] < 1.0:
        raise AssertionError(f"eval path: AR {ar['AR']}")
    if mismatch or depth_err > K1_ATOL or hit_px == 0:
        raise AssertionError(f"K1 at the evaluation shape: {mismatch} hit-mask mismatches, depth {depth_err}, "
                             f"{hit_px} hits")
    if not (wrong_check["hit_mask_mismatches"] > 0 or wrong_check["depth_max_err"] > K1_ATOL):
        raise AssertionError(f"K1's gate does not fail a kernel that drops each tile's first slot: {wrong_check}")
    return result, launches


# VOS path: vos_inference on the video phase's frames, prompted with the
# two objects' frame-0 masks as drawn (the annotation a DAVIS / SA-V tree
# holds). The CLI runs once, on the kernels; the kernels are held to the
# plain attention on the mask-prompted propagation, each object's own mask
# before the non-overlap constraint, on frames 1-9. The CLI's output is not
# compared: with random weights most mask pixels hold logits near 0 and the
# two objects' logits cross, so a rounding change alone moves the pixels the
# non-overlap constraint gives each object (J&F 0.670 for the plain
# attention against itself with p in fp32, PERF.md).


def phase_vos(dev) -> tuple[dict, dict]:
    """Semi-supervised VOS at full width through its CLI: vos_inference
    (SAM2 Hiera-L at 1024², bf16, seeded random weights with the object-score
    bias) on the video phase's 10 frames at 1280x720 with the two objects'
    frame-0 masks as drawn (`synthetic_video`) in one palette PNG, on the
    kernels. Then mask-prompted propagation timed per frame on the same
    functions, and again on the plain attention.

    The video phase's tracked frame-0 masks would be the cheaper prompt, but
    with random weights both are one blob (65,629 and 63,010 px of the same
    region), so the palette's lowest-id-wins merge leaves object 2 with 87
    px, and the two objects then fight over the same pixels under the
    non-overlap constraint: a chaotic track, not a test of the kernels."""
    import contextlib
    import io

    from freepose_tpu_torch.datasets.video import load_frame_dir
    from freepose_tpu_torch.evaluation.vos_metrics import track_j_and_f
    from freepose_tpu_torch.ops import attention
    from freepose_tpu_torch.scripts import vos_inference
    from freepose_tpu_torch.scripts.extract_proposals_ground_video import load_video_predictor

    root = WORK_DIR / "vos"
    (root / "videos").mkdir(parents=True)
    (root / "videos" / "smoke").symlink_to(WORK_DIR / "frames", target_is_directory=True)
    (root / "masks" / "smoke").mkdir(parents=True)
    masks0 = np.load(WORK_DIR / "drawn_masks0.npy")  # [2, H, W] bool
    h, w = masks0.shape[1:]
    ann = vos_inference.put_per_obj_mask({i + 1: m for i, m in enumerate(masks0)}, h, w)
    vos_inference.save_ann_png(root / "masks" / "smoke" / "00000.png", ann, vos_inference.davis_palette())
    prompt_px = [int((ann == i + 1).sum()) for i in range(len(masks0))]

    out_dir = root / "out"
    argv = ["--base-video-dir", str(root / "videos"), "--input-mask-dir", str(root / "masks"),
            "--output-mask-dir", str(out_dir), "--device", str(dev)]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        vos_inference.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = read_launches()
    sam2_graphs = sam2_graph_counts("vos", VIDEO_FRAMES - 1)  # one mask-prompted group on frame 0
    anns = [vos_inference.load_ann_png(p)[0] for p in sorted((out_dir / "smoke").glob("*.png"))]
    ids = [sorted(int(i) for i in np.unique(a) if i) for a in anns]
    cli_px = [[int((a == i).sum()) for i in (1, 2)] for a in anns]
    del anns

    # Mask-prompted propagation on the same functions: per frame on the
    # kernels (timed), then on the plain attention; each object's own mask
    # and the low-res logits compared before the non-overlap constraint,
    # which touches only the output (a pixel whose winning object flips
    # drops to -10 there).
    frames = load_frame_dir(root / "videos" / "smoke")
    predictor = load_video_predictor(None, device=dev)

    def propagate(plain: bool):
        state = predictor.init_state(frames)
        for i, m in enumerate(masks0):
            state = predictor.add_new_mask(state, 0, i + 1, m)
        kernel_auto = attention.flash_attention_auto
        if plain:
            attention.flash_attention_auto = plain_attention_auto
        lows, highs, ms = [], [], []
        try:
            gen = predictor.propagate_in_video(state, chunk=1)  # frame at a time
            while True:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                item = next(gen, None)
                if item is None:
                    break
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                lows.append(item[2])
                highs.append(item[3] > 0)
        finally:
            attention.flash_attention_auto = kernel_auto
        return lows, np.stack(highs), ms  # highs [T, objects, H, W]

    low_k, high_k, frame_ms = propagate(False)
    low_p, high_p, _ = propagate(True)
    del predictor
    torch.cuda.empty_cache()
    # Frames 1-9: frame 0 is the prompt, its masks equal by construction.
    logit_diff = max(float(np.abs(a - b).max()) for a, b in zip(low_k[1:], low_p[1:]))
    logit_scale = max(float(np.abs(b).max()) for b in low_p[1:])
    ious = [[int((a & b).sum()) / union if (union := int((a | b).sum())) else 1.0 for a, b in zip(hk, hp)]
            for hk, hp in zip(high_k[1:], high_p[1:])]
    # Each object's J&F, kernels against plain, by the CLI's protocol (the
    # track's first and last frames left out).
    jf = [track_j_and_f(high_k[:, o], high_p[:, o]) for o in range(len(masks0))]
    own_px = {"kernels": high_k[1:].sum(axis=(2, 3)).tolist(), "plain": high_p[1:].sum(axis=(2, 3)).tolist()}
    # Of the plain run's mask pixels (low-res logit > 0) on frames 1-9, the
    # share whose logit lies within VIDEO_LOGIT_ATOL of 0 (a rounding
    # difference of that size may flip them).
    pos = np.concatenate([b[b > 0] for b in low_p[1:]])
    near_zero_share = float((pos < VIDEO_LOGIT_ATOL).mean()) if pos.size else None

    k2 = {str(d): launches["K2_by_dim"].get(str(d), 0) for d in (64, 72, 256)}
    result = dict(frames=VIDEO_FRAMES, frame_hw=list(VIDEO_HW), objects=len(masks0), prompt_px=prompt_px,
                  cli_s=cli_s, cli_ms_per_frame=cli_s * 1e3 / VIDEO_FRAMES, cli_object_px=cli_px,
                  ms_per_frame=float(np.median(frame_ms[1:])), prompt_frame_ms=frame_ms[0], frame_ms=frame_ms,
                  own_mask_px_frames_1_9=own_px, own_mask_iou_frames_1_9=ious,
                  own_mask_iou_mean=float(np.mean(ious)), own_mask_iou_min=float(np.min(ious)),
                  own_mask_j_and_f_kernels_vs_plain=jf, low_res_logit_max_abs_diff=logit_diff,
                  low_res_logit_max_abs=logit_scale, mask_logits_near_zero_share=near_zero_share,
                  k2_launches_by_dim=k2, k4_launches=launches["K4"], launches=launches, sam2_graphs=sam2_graphs,
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log("vos", **result)
    if min(k2["72"], k2["256"], launches["K4"]) <= 0:
        raise AssertionError(f"vos path: kernel launches {launches}")
    if len(ids) != VIDEO_FRAMES or any(i != [1, 2] for i in ids):
        raise AssertionError(f"vos path: {len(ids)} mask PNGs, object ids per frame {ids}")
    if np.mean(ious) < VIDEO_IOU_MIN or np.min(ious) < VOS_IOU_FLOOR or logit_diff > VIDEO_LOGIT_ATOL or \
            min(r["J&F"] for r in jf) < VOS_JF_MIN:
        raise AssertionError(f"vos path, kernels vs plain attention on frames 1-9: own-mask IoU mean "
                             f"{np.mean(ious)}, min {np.min(ious)}, J&F {jf}, low-res logits max abs diff "
                             f"{logit_diff}")
    return result, launches


# Textured templates: a seeded UV torus whose seams are split per corner,
# (124 + 1)·(64 + 1) = 8,125 vertices and 15,872 faces (within the renderer's
# 8,192 / 16,384 budget, so load_obj subdivides nothing and fit_to_budget
# decimates nothing), with a 2,048² PNG atlas of seeded coloured cells and
# noise. Atlas values stay below 0.5, so the renderer's ambient 2.0 clips no
# texel and the sampled atlas shows against the bake.
TEXTURE_NAME, TEXTURE_UV_GRID, TEXTURE_ATLAS = "texturedtorus", (124, 64), 2048
TEXTURE_DIFF_MIN = 2 / 255  # a hit pixel "differs" from the bake by more than two 8-bit steps
TEXTURE_DIFF_SHARE_MIN = 0.5  # ... on most hit pixels


def write_textured_torus(root: Path, seed: int = SEED) -> Path:
    """OBJ, MTL and PNG atlas of the textured torus under root/<name>/."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    n_u, n_v = TEXTURE_UV_GRID
    verts = torus_positions(rng, n_u, n_v)
    su, sv = np.meshgrid(np.arange(n_u + 1) / n_u, np.arange(n_v + 1) / n_v, indexing="ij")
    i, j = np.meshgrid(np.arange(n_u), np.arange(n_v), indexing="ij")
    pos = lambda a, b: (a % n_u) * n_v + b % n_v + 1  # noqa: E731  (1-based OBJ indices)
    tex = lambda a, b: a * (n_v + 1) + b + 1  # noqa: E731
    corners = [(i, j), (i + 1, j), (i, j + 1), (i + 1, j + 1)]
    (a, b, c, d) = [(pos(x, y).ravel(), tex(x, y).ravel()) for x, y in corners]
    tris = [(a, b, c), (b, d, c)]
    cells = rng.uniform(0.05, 0.4, (16, 16, 3))
    y, x = np.mgrid[0:TEXTURE_ATLAS, 0:TEXTURE_ATLAS] * 16 // TEXTURE_ATLAS
    atlas = cells[y, x] + rng.uniform(0.0, 0.1, (TEXTURE_ATLAS, TEXTURE_ATLAS, 3))
    out = root / TEXTURE_NAME
    out.mkdir(parents=True, exist_ok=True)
    Image.fromarray(np.round(atlas * 255).astype(np.uint8)).save(out / "atlas.png")
    (out / f"{TEXTURE_NAME}.mtl").write_text("newmtl torus\nmap_Kd atlas.png\n")
    lines = [f"mtllib {TEXTURE_NAME}.mtl", "usemtl torus"]
    lines += [f"v {p[0]:.7f} {p[1]:.7f} {p[2]:.7f}" for p in verts]
    lines += [f"vt {s:.7f} {t:.7f}" for s, t in zip(su.ravel(), sv.ravel())]
    for tri in tris:
        lines += [" ".join(["f"] + [f"{vi[k]}/{ti[k]}" for vi, ti in tri]) for k in range(n_u * n_v)]
    path = out / f"{TEXTURE_NAME}.obj"
    path.write_text("\n".join(lines) + "\n")
    return path


def dinov2_hub_state_dict(tree: dict) -> dict:
    """The JAX-layout DINOv2 tree -> a torch.hub facebookresearch/dinov2
    state dict (the names of models.convert.dinov2_from_hub's docstring):
    the inverse of that converter, mask_token included (zeros; unused)."""
    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))

    blk = tree["blocks"]["block"]
    d = tree["norm"]["scale"].shape[0]
    sd = {"patch_embed.proj.weight": t(tree["patch_embed"]["kernel"].transpose(3, 2, 0, 1)),  # HWIO -> OIHW
          "patch_embed.proj.bias": t(tree["patch_embed"]["bias"]), "cls_token": t(tree["cls_token"]),
          "register_tokens": t(tree["reg_tokens"]), "pos_embed": t(tree["pos_embed"]),
          "mask_token": torch.zeros(1, d), "norm.weight": t(tree["norm"]["scale"]), "norm.bias": t(tree["norm"]["bias"])}
    for i in range(blk["norm1"]["scale"].shape[0]):
        p = f"blocks.{i}"
        for name in ("norm1", "norm2"):
            sd[f"{p}.{name}.weight"], sd[f"{p}.{name}.bias"] = t(blk[name]["scale"][i]), t(blk[name]["bias"][i])
        for name, node in (("attn.qkv", blk["attn"]["qkv"]), ("attn.proj", blk["attn"]["proj"]),
                           ("mlp.fc1", blk["mlp"]["fc1"]), ("mlp.fc2", blk["mlp"]["fc2"])):
            sd[f"{p}.{name}.weight"], sd[f"{p}.{name}.bias"] = t(node["kernel"][i].T), t(node["bias"][i])
        sd[f"{p}.ls1.gamma"], sd[f"{p}.ls2.gamma"] = t(blk["ls1"]["gamma"][i]), t(blk["ls2"]["gamma"][i])
    return sd


def trees_identical(a: dict, b: dict) -> bool:
    """Same leaf paths, dtypes, shapes and bits."""
    from freepose_tpu_torch.models.convert import _tree_leaves

    la, lb = dict(_tree_leaves(a)), dict(_tree_leaves(b))
    return la.keys() == lb.keys() and all(
        np.asarray(la[k]).dtype == np.asarray(lb[k]).dtype and np.array_equal(la[k], lb[k]) for k in la)


def phase_texture(dev) -> tuple[dict, dict]:
    """Textured template assets at full width through the entry points:
    load_obj of a textured OBJ (2,048² atlas), DINOv2-L weights through the
    port's convert_weights and prepare_weights from a torch.hub-layout .pth,
    render_templates (600 textured views at 420²: K1 carries each UV pass),
    the textured TemplateBank.build_pack and extract_retrieval_features on
    the shard with the converted .npz (K2 d 64). Then K1 on one UV chunk
    against its plain version, the shading pass timed against its bound, the
    pack and the CLI with every kernel on its plain version, and the host
    CLIs resize_meshes and merge_results."""
    import contextlib
    import dataclasses
    import io

    import pandas as pd

    from freepose_tpu_torch.io.mesh import fit_to_budget, load_obj, pad_uv
    from freepose_tpu_torch.models import vit
    from freepose_tpu_torch.models.convert import load_params
    from freepose_tpu_torch.models.dinov2 import VIT_L14_REG
    from freepose_tpu_torch.ops.attention import dense_attention, flash_attention_fn
    from freepose_tpu_torch.ops.rasterizer import RasterSettings, render_meshes
    from freepose_tpu_torch.ops.rasterizer_cuda import prologue, raster_tile, raster_tile_plain
    from freepose_tpu_torch.ops.texture import shade_uv_image
    from freepose_tpu_torch.pipeline.renderer import RENDERING_SCALE, TemplateRenderer
    from freepose_tpu_torch.pipeline.template_bank import TemplateBank, normalize_feats
    from freepose_tpu_torch.scripts import (convert_weights, extract_retrieval_features, merge_results,
                                            prepare_weights, render_templates, resize_meshes)
    from freepose_tpu_torch.scripts.common import load_dino_extractor

    work = WORK_DIR / "texture"
    obj = write_textured_torus(work / "meshes")
    (work / "filelist.txt").write_text(TEXTURE_NAME + "\n")

    # 1. Load: the atlas and the UVs must be there (without PIL, load_obj
    # would quietly give the bake alone).
    t0 = time.perf_counter()
    raw = load_obj(obj)
    load_s = time.perf_counter() - t0
    if raw.texture is None or raw.uv is None or raw.texture.shape != (TEXTURE_ATLAS, TEXTURE_ATLAS, 3):
        raise AssertionError(f"load_obj lost the atlas or the UVs: texture "
                             f"{None if raw.texture is None else raw.texture.shape}, uv {raw.uv is not None}")
    mesh = raw.normalized()

    # 2. DINOv2-L/14-reg weights through the CLIs a user calls: a torch.hub
    # .pth -> convert_weights -> .npz, and prepare_weights on a checkpoint
    # directory that holds only that file.
    cli_out = io.StringIO()
    tree = random_dinov2_params(VIT_L14_REG)
    (work / "ckpt").mkdir(exist_ok=True)
    pth = work / "ckpt" / "dinov2_vitl14_reg4_pretrain.pth"
    torch.save(dinov2_hub_state_dict(tree), pth)
    npz = work / "dinov2_vitl.npz"
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(cli_out):
        convert_weights.main(["--kind", "dinov2-hub", "--ckpt", str(pth), "--layers", "24", "--out", str(npz)])
    convert_s = time.perf_counter() - t0
    converted_identical = trees_identical(load_params(npz), tree)
    prep_out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(prep_out):
        prepare_weights.main(["--ckpt-dir", str(work / "ckpt"), "--out-dir", str(work / "params")])
    prepare_s = time.perf_counter() - t0
    prepared_identical = trees_identical(load_params(work / "params" / "dinov2_vitl.npz"), load_params(npz))
    prepare_summary = prep_out.getvalue().strip().splitlines()[-1]
    del tree
    if not converted_identical or not prepared_identical or not prepare_summary.startswith(
            "1 families ready, 6 missing") or prep_out.getvalue().count("MISSING") != 6:
        raise AssertionError(f"weights CLIs: convert_weights .npz identical to the tree {converted_identical}, "
                             f"prepare_weights .npz identical {prepared_identical}, summary {prepare_summary!r}")

    # 3. The path, once, through the entry points: render_templates, then the
    # textured pack (cold and warm) and extract_retrieval_features.
    extractor = load_dino_extractor(str(npz), device=dev)

    def feature_fn(imgs):
        return extractor(imgs, layer=DINO_LAYER, feature_type="patch")

    renderer = TemplateRenderer(n_poses=N_VIEWS, resolution=RES, device=dev)
    bank = TemplateBank(feature_fn, renderer=renderer, batch_size=BANK_BATCH, device=dev)
    feats_argv = ["--wds-dir", str(work / "shards"), "--filelist", str(work / "filelist.txt"),
                  "--weights", str(npz), "--layer", str(DINO_LAYER), "--device", str(dev)]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(cli_out):
        render_templates.main(["--mesh-dir", str(work / "meshes"), "--filelist", str(work / "filelist.txt"),
                               "--out", str(work / "shards"), "--device", str(dev)])
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    render_k1 = read_launches()["K1"]
    t0 = time.perf_counter()
    pack = bank.build_pack(TEXTURE_NAME, mesh)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bank.build_pack(TEXTURE_NAME, mesh)
    torch.cuda.synchronize()
    pack_warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(cli_out):
        extract_retrieval_features.main([*feats_argv, "--out", str(work / "feats")])
    torch.cuda.synchronize()
    features_s = time.perf_counter() - t0
    launches = read_launches()
    view_feats = np.load(work / "feats" / f"{TEXTURE_NAME}.npy")

    # The baked pack of the same mesh, warm, for comparison.
    bake_renderer = TemplateRenderer(n_poses=N_VIEWS, resolution=RES, texture_mode="bake", device=dev)
    bake_bank = TemplateBank(feature_fn, renderer=bake_renderer, batch_size=BANK_BATCH, device=dev)
    bake_bank.build_pack(TEXTURE_NAME, mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bake_bank.build_pack(TEXTURE_NAME, mesh)
    torch.cuda.synchronize()
    bake_pack_warm_s = time.perf_counter() - t0

    # 4. K1 on the first 128-pose chunk of the UV pass against its plain
    # version: (u, v, w) as the colour attribute at ambient 1.
    fitted = fit_to_budget(mesh, renderer.max_vertices, renderer.max_faces)
    v, _, f, valid = renderer._padded(fitted, RENDERING_SCALE)
    uvw = torch.as_tensor(pad_uv(fitted, renderer.max_vertices), device=dev)
    uv_settings = dataclasses.replace(renderer.settings, ambient=1.0, depth_only=False)
    poses = renderer.poses[:CHUNK]
    rows, slots = prologue(v, uvw, f, valid, poses, renderer.k.expand(CHUNK, 3, 3), uv_settings)
    before = read_launches()["K1"]
    out = raster_tile(rows, slots, RES, TILE, 1.0, False)
    ref = raster_tile_plain(rows, slots, RES, TILE, 1.0, False)
    wrong = reads_next_pose(rows, slots, RES, TILE, 1.0, False)

    def k1_check(x):
        return (int(((x[..., 0] > 0) != (ref[..., 0] > 0)).sum()), float((x[..., 0] - ref[..., 0]).abs().max()),
                float((x[..., 1:] - ref[..., 1:]).abs().max()))

    k1 = dict(zip(("hit_mask_mismatches", "depth_max_err", "uvw_max_err"), k1_check(out)),
              hit_px=int((out[..., 0] > 0).sum()), vertices=fitted.num_vertices, faces=fitted.num_faces,
              reads_next_pose=dict(zip(("hit_mask_mismatches", "depth_max_err", "uvw_max_err"), k1_check(wrong))))
    k1_launches_check = read_launches()["K1"] - before
    k1["ms"] = cuda_ms(lambda: raster_tile(rows, slots, RES, TILE, 1.0, False), reps=10)
    k1["device"] = device_ms(lambda: raster_tile(rows, slots, RES, TILE, 1.0, False), reps=5)
    k1.update({key: val for key, val in k1_bound(rows, slots, RES, TILE, False).items()
               if key in ("bound_ms", "bound_by", "valid_pairs")})
    del rows, slots, out, ref, wrong

    # 5. Shading: the atlas sampled per pixel, timed per chunk against its
    # bound (read the UV image, the depth and the atlas once, write the RGB).
    texture = torch.as_tensor(fitted.texture, device=dev)
    uv_img, depth = render_meshes(v, uvw, f, valid, poses, renderer.k, uv_settings)
    ambient = renderer.settings.ambient
    shade_ms = cuda_ms(lambda: shade_uv_image(uv_img, depth, texture, ambient), reps=5)
    shade_device = device_ms(lambda: shade_uv_image(uv_img, depth, texture, ambient), reps=3)
    pixels = uv_img.shape[0] * RES * RES
    shade_bytes = pixels * (3 + 1 + 3) * 4 + texture.numel() * 4
    shade_bound_ms, shade_bound_by = bound(0, shade_bytes)
    rgb_tex, depth_tex = renderer.render_from_poses(mesh, poses)
    rgb_bake, depth_bake = bake_renderer.render_from_poses(mesh, poses)
    hit = depth_tex > 0
    same_geometry = bool(torch.equal(hit, depth_bake > 0))
    diff = (rgb_tex - rgb_bake).abs().amax(-1)[hit]
    diff_share = float((diff > TEXTURE_DIFF_MIN).float().mean())
    shading = dict(ms=shade_ms, device=shade_device, bound_ms=shade_bound_ms, bound_by=shade_bound_by,
                   bound_bytes=shade_bytes, bound_share=shade_bound_ms / shade_device if shade_device else None,
                   poses=uv_img.shape[0], textured_vs_baked_diff_share=diff_share,
                   textured_vs_baked_diff_mean=float(diff.mean()), same_geometry=same_geometry)
    del uv_img, depth, rgb_tex, rgb_bake, depth_tex, depth_bake, texture

    # 6. The pack and the CLI again with every kernel on its plain version.
    plain_renderer = TemplateRenderer(n_poses=N_VIEWS, resolution=RES, device=dev,
                                      settings=RasterSettings(resolution=RES, backend="xla"))
    plain_bank = TemplateBank(feature_fn, renderer=plain_renderer, batch_size=BANK_BATCH, device=dev)
    before = read_launches()
    for blk in extractor.model.blocks:
        blk.attn.attention_fn = dense_attention
    vit.flash_attention_fn = dense_attention  # the CLI's model is built with it
    try:
        t0 = time.perf_counter()
        plain_pack = plain_bank.build_pack(TEXTURE_NAME, mesh)
        torch.cuda.synchronize()
        plain_pack_s = time.perf_counter() - t0
        with contextlib.redirect_stdout(cli_out):
            extract_retrieval_features.main([*feats_argv, "--out", str(work / "feats_plain")])
    finally:
        vit.flash_attention_fn = flash_attention_fn
        for blk in extractor.model.blocks:
            blk.attn.attention_fn = flash_attention_fn
    after = read_launches()
    plain_launches = {"K1": after["K1"] - before["K1"],
                      "K2_d64": after["K2_by_dim"].get("64", 0) - before["K2_by_dim"].get("64", 0)}
    plain_feats = np.load(work / "feats_plain" / f"{TEXTURE_NAME}.npy")
    pack_cos = (normalize_feats(pack.feats.float()) * normalize_feats(plain_pack.feats.float())).sum(-1)
    cli_cos = (view_feats * plain_feats).sum(-1) / np.maximum(
        np.linalg.norm(view_feats, axis=-1) * np.linalg.norm(plain_feats, axis=-1), 1e-12)
    kernel_vs_plain = {"pack_patch_cos_min": float(pack_cos.min()), "features_cos_min": float(cli_cos.min()),
                       "launches": {"kernels": {"K1": launches["K1"], "K2_d64": launches["K2_by_dim"].get("64", 0)},
                                    "plain": plain_launches}}
    del extractor, bank, bake_bank, plain_bank, pack, plain_pack

    # 7. The host CLIs: resize_meshes on the mesh directory, merge_results on
    # two CSVs cut from the refine phase's.
    with contextlib.redirect_stdout(cli_out):
        resize_meshes.main(["--mesh-dir", str(work / "meshes"), "--out", str(work / "resized")])
    resized = load_obj(work / "resized" / TEXTURE_NAME / f"{TEXTURE_NAME}.obj")
    lo, hi = resized.bounds()
    resize = dict(half_extent=resized.half_extent(), centre=((hi + lo) / 2).tolist(),
                  vertices=resized.num_vertices, atlas_kept=resized.texture is not None)
    chain = pd.read_csv(WORK_DIR / "chain.csv")
    (work / "results").mkdir(exist_ok=True)
    half = len(chain) // 2
    chain.iloc[:half].to_csv(work / "results" / "part-0.csv", index=False)
    chain.iloc[half:].to_csv(work / "results" / "part-1.csv", index=False)
    with contextlib.redirect_stdout(cli_out):
        merge_results.main(["--results-dir", str(work / "results"), "--out", str(work / "merged.csv")])
    merged_equal = bool(pd.read_csv(work / "merged.csv").equals(chain))

    result = dict(mesh=dict(vertices=raw.num_vertices, faces=raw.num_faces, atlas=list(raw.texture.shape),
                            load_obj_s=load_s),
                  weights=dict(convert_s=convert_s, prepare_s=prepare_s, pth_gb=pth.stat().st_size / 1e9,
                               converted_identical=converted_identical, prepared_identical=prepared_identical,
                               prepare_summary=prepare_summary),
                  render_templates_s=render_s, render_k1_launches=render_k1, pack_s=pack_s,
                  pack_warm_s=pack_warm_s, bake_pack_warm_s=bake_pack_warm_s, plain_pack_s=plain_pack_s,
                  bank_features_s=features_s, view_features_shape=list(view_feats.shape), k1_uv_chunk=k1,
                  shading=shading, kernel_vs_plain=kernel_vs_plain, resize=resize, merge=dict(
                      rows=len(chain), merged_equal=merged_equal), launches=launches,
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log("texture", **result)
    if launches["K1"] <= 0 or launches["K2_by_dim"].get("64", 0) <= 0:
        raise AssertionError(f"texture path did not launch K1 and K2 at d 64: {launches}")
    if k1["hit_mask_mismatches"] or max(k1["depth_max_err"], k1["uvw_max_err"]) > K1_ATOL or not k1["hit_px"] \
            or k1_launches_check != 1:
        raise AssertionError(f"K1 on the UV pass disagrees with its plain version: {k1}")
    wrong = k1["reads_next_pose"]
    if not (wrong["hit_mask_mismatches"] > 0 or max(wrong["depth_max_err"], wrong["uvw_max_err"]) > K1_ATOL):
        raise AssertionError(f"K1's UV gate does not fail a kernel that reads the next pose's rows: {wrong}")
    if not same_geometry or diff_share < TEXTURE_DIFF_SHARE_MIN:
        raise AssertionError(f"textured vs baked renders: {shading}")
    if view_feats.shape != (N_VIEWS, BANK_DIM) or not np.isfinite(view_feats).all():
        raise AssertionError(f"texture bank features {view_feats.shape}")
    if min(kernel_vs_plain["pack_patch_cos_min"], kernel_vs_plain["features_cos_min"]) < FEATURE_COS_MIN \
            or max(plain_launches.values()) != 0:
        raise AssertionError(f"texture path, kernels vs plain versions: {kernel_vs_plain}")
    if abs(resize["half_extent"] - 1.0) > 1e-5 or max(abs(c) for c in resize["centre"]) > 1e-5 or not merged_equal:
        raise AssertionError(f"host CLIs: resize_meshes {resize}, merge_results equal {merged_equal}")
    return result, launches


# The coupled video step: SAM2's batches (the prompt frame alone, then runs
# of up to COUPLED_CHUNK frames) feed the fine refine on the card, and the
# smooth stage's confidence chunks (DINOv2-B at 518², CONF_CHUNK frames)
# stream behind it. The refine's object scale is fixed (no scale stage runs
# here). Crops of the coupled path against the host path (the fetched mask
# through extract_proposals): the same fp32 gathers and weights, within
# COUPLED_CROP_ATOL; poses of the two chains within COUPLED_POSE_ATOL.
COUPLED_CHUNK, CONF_CHUNK, COUPLED_SCALE = 8, 8, 0.15
COUPLED_CROP_ATOL = COUPLED_POSE_ATOL = 1e-5


def h2d_copies(fn) -> dict:
    """Host-to-device copies during one call of `fn` (torch.profiler's
    trace of the card): how many, their bytes, the largest."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path = WORK_DIR / "h2d_trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    sizes = [int(e.get("args", {}).get("bytes", 0)) for e in events
             if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    return {"copies": len(sizes), "bytes": sum(sizes), "largest": sorted(sizes)[-8:]}


def mask_ious(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU of each pair of bool masks [..., H, W] (1 where both are empty)."""
    inter = (a & b).sum(axis=(-2, -1))
    union = (a | b).sum(axis=(-2, -1))
    return np.where(union > 0, inter / np.maximum(union, 1), 1.0)


def phase_coupled(dev, mesh) -> tuple[dict, dict]:
    """The coupled video step at full width: synthetic_video()'s 10 frames
    staged on the card in one upload, object 0 prompted by its frame-0 box,
    SAM2 Hiera-L (bf16, object-score bias) through propagate_batched, each
    batch's masks and frames through proposals_from_masks_video, frame 0's
    coarse pose from the torus's 600-view pack and frames 1-9 through an
    AutoRefineChain with the refine phase's settings, and a StreamingInliers
    fed as the chain finalises poses."""
    from freepose_tpu_torch.datasets.video import stage_frames_hbm
    from freepose_tpu_torch.geometry.boxes import mask_to_bbox
    from freepose_tpu_torch.geometry.camera import default_video_intrinsics
    from freepose_tpu_torch.models.convert import save_params
    from freepose_tpu_torch.models.cotracker import PointTracker
    from freepose_tpu_torch.models.dinov2 import VIT_B14_REG, VIT_L14_REG
    from freepose_tpu_torch.ops import attention
    from freepose_tpu_torch.pipeline.online_pose_estimator import AutoRefineChain, OnlinePoseEstimator
    from freepose_tpu_torch.pipeline.proposals import extract_proposals, proposals_from_masks_video
    from freepose_tpu_torch.pipeline.renderer import TemplateRenderer
    from freepose_tpu_torch.pipeline.template_bank import TemplateBank
    from freepose_tpu_torch.pipeline.tracking_refiner import StreamingInliers, TrackingRefiner
    from freepose_tpu_torch.scripts.common import load_dino_extractor
    from freepose_tpu_torch.scripts.extract_proposals_ground_video import load_video_predictor

    WORK_DIR.mkdir(parents=True, exist_ok=True)
    frames, boxes, _ = synthetic_video()
    n = len(frames)
    h, w = frames.shape[1:3]
    t0 = time.perf_counter()
    staged = stage_frames_hbm(frames, device=dev)
    torch.cuda.synchronize()
    stage_ms = (time.perf_counter() - t0) * 1e3
    predictor = load_video_predictor(None, device=dev)
    for name, cfg, seed in (("dinov2.npz", VIT_L14_REG, SEED), ("dinov2_vitb.npz", VIT_B14_REG, SEED + 9)):
        if not (WORK_DIR / name).exists():  # the refine and smooth phases' weights
            save_params(random_dinov2_params(cfg, seed=seed), WORK_DIR / name)
    extractor = load_dino_extractor(str(WORK_DIR / "dinov2.npz"), device=dev)
    extractor_b = load_dino_extractor(str(WORK_DIR / "dinov2_vitb.npz"), model="vitb", device=dev)

    def feature_fn(imgs):
        return extractor(imgs, layer=DINO_LAYER, feature_type="patch")

    renderer = TemplateRenderer(n_poses=N_VIEWS, device=dev)
    est = OnlinePoseEstimator(feature_fn, TemplateBank(feature_fn, renderer, cache_size=4, device=dev), renderer,
                              n_coarse_poses=N_VIEWS, n_fine_poses=N_FINE, n_neighbors=N_NEIGHBORS,
                              extractor=extractor, feature_layer=DINO_LAYER, fine_cache_capacity=FINE_CACHE)
    pack = est.coarse.bank.build_pack("coupled_torus", mesh)
    refiner = TrackingRefiner(feature_fn=lambda imgs: extractor_b(imgs, layer=None, feature_type="patch"),
                              tracker=PointTracker(device=dev), device=dev)
    conf_mesh = mesh.scaled(COUPLED_SCALE)
    k = default_video_intrinsics(w, h, device=dev)
    box0 = boxes[0, 0]

    def prompted(src):
        return predictor.add_new_points_or_box(predictor.init_state(src), 0, obj_id=0, box=box0)

    def run_chain(per_frame, sync=False):
        """Frame 0's coarse pose, frames 1.. through a fresh chain, from
        (crop, crop mask, bbox) per frame -> (frame 0 pose, chain, ms per
        frame when sync)."""
        chain = AutoRefineChain(est, mesh, "coupled", neighborhood_deg=NEIGHBORHOOD)
        first, ms = None, []
        for t, (crop, cmask, bbox) in enumerate(per_frame):
            t0 = time.perf_counter()
            if t == 0:
                first = est.coarse.estimate(crop, pack, k, bbox, COUPLED_SCALE).tcos[0]
            else:
                chain.submit(crop, cmask, k, bbox, COUPLED_SCALE, prev_pose=first if t == 1 else None)
            if sync:
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
        chain.finalize_all()
        return first, chain, ms

    def coupled(sync: bool = False) -> dict:
        """One pass of the coupled step; with sync, each batch timed to the
        card's finish (its frames share the batch's time)."""
        chain = AutoRefineChain(est, mesh, "coupled", neighborhood_deg=NEIGHBORHOOD)
        conf = StreamingInliers(refiner, conf_mesh, staged, k, chunk=CONF_CHUNK)
        batches, frame_ms, fed, first = [], [], 0, None
        t0 = time.perf_counter()
        for ts, lows, highs, frames_b in predictor.propagate_batched(prompted(staged), chunk=COUPLED_CHUNK):
            crops, cmasks, bboxes = proposals_from_masks_video(frames_b, highs[:, 0], RES, 0.2)
            for z, t in enumerate(ts):
                if t == 0:
                    first = est.coarse.estimate(crops[z], pack, k, bboxes[z], COUPLED_SCALE).tcos[0]
                    conf.add(0, first.cpu().numpy())
                else:
                    chain.submit(crops[z], cmasks[z], k, bboxes[z], COUPLED_SCALE,
                                 prev_pose=first if t == 1 else None)
            while fed < len(chain.results):
                conf.add(fed + 1, chain.results[fed][0])
                fed += 1
            batches.append((ts, lows, highs, frames_b, crops, cmasks, bboxes))
            if sync:
                torch.cuda.synchronize()
                now = time.perf_counter()
                frame_ms += [(now - t0) * 1e3 / len(ts)] * len(ts)
                t0 = now
        results = chain.finalize_all()
        while fed < len(results):
            conf.add(fed + 1, results[fed][0])
            fed += 1
        inliers, thr = conf.finalize()
        return dict(first=first, chain=chain, batches=batches, frame_ms=frame_ms, inliers=inliers, thr=thr)

    # The path, once, with the launch counts.
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    run = coupled()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = read_launches()
    sam2_graphs = sam2_graph_counts("coupled", n - 1)  # one object group, prompted on frame 0
    plan = [b[0] for b in run["batches"]]
    poses = [run["first"].cpu().numpy()] + [p for p, _ in run["chain"].results]

    # Timed: the whole step per batch, SAM2 alone per batch, the refine alone
    # per frame (fed the first run's crops).
    frame_ms = coupled(sync=True)["frame_ms"]
    sam_ms, t0 = [], time.perf_counter()
    for ts, *_ in predictor.propagate_batched(prompted(staged), chunk=COUPLED_CHUNK):
        torch.cuda.synchronize()
        now = time.perf_counter()
        sam_ms += [(now - t0) * 1e3 / len(ts)] * len(ts)
        t0 = now
    per_frame = [(b[4][z], b[5][z], b[6][z]) for b in run["batches"] for z in range(len(b[0]))]
    _, _, refine_ms = run_chain(per_frame, sync=True)
    profile = profile_device_time(lambda: coupled(), "coupled_video", top=16)
    h2d = h2d_copies(lambda: coupled())

    # Gates. The batches' masks against propagate_in_video(binarize=True)
    # from the host frames, the batches' frames against the staged video.
    ref = {t: (low, high) for t, _, low, high in predictor.propagate_in_video(prompted(frames), binarize=True,
                                                                              chunk=COUPLED_CHUNK)}
    mask_mismatch, frames_equal, host = 0, True, []
    for ts, lows, highs, frames_b, crops, cmasks, bboxes in run["batches"]:
        lows_np, highs_np = lows.cpu().numpy(), highs.cpu().numpy()
        frames_equal &= bool(torch.equal(frames_b, staged.frames[min(ts):max(ts) + 1]))
        for z, t in enumerate(ts):
            mask_mismatch += int((lows_np[z] != ref[t][0]).sum() + (highs_np[z] != ref[t][1]).sum())
            m = torch.as_tensor(highs_np[z, 0], device=dev)
            bbox = mask_to_bbox(m).float() if bool(m.any()) else \
                torch.tensor([w * 0.25, h * 0.25, w * 0.75, h * 0.75], device=dev)
            prop = extract_proposals(torch.as_tensor(frames[t], device=dev), m[None], bbox[None], RES, 0.2)
            host.append(dict(crop_err=float((prop.proposals[0] - crops[z]).abs().max()),
                             cmask_equal=bool(torch.equal(prop.masks[0], cmasks[z])),
                             bbox_equal=bool(torch.equal(bbox, bboxes[z])), mask_px=int(m.sum()),
                             inputs=(prop.proposals[0], prop.masks[0], bbox)))
    host_first, host_chain, _ = run_chain([x.pop("inputs") for x in host])
    host_poses = [host_first.cpu().numpy()] + [p for p, _ in host_chain.results]
    pose_err = max(float(np.abs(a - b).max()) for a, b in zip(poses, host_poses))
    score_err = max(abs(a[1] - b[1]) for a, b in zip(run["chain"].results, host_chain.results))
    batch_inl, batch_thr = refiner.n_inliers_per_pose(conf_mesh, staged.frames[:n], k, np.stack(poses),
                                                      chunk=CONF_CHUNK, channels_last=True)
    inliers_equal = bool(np.array_equal(run["inliers"], batch_inl)) and run["thr"] == batch_thr

    # Kernels vs plain versions: SAM2's masks on frames 1 to COUPLED_CHUNK,
    # one full batch through the trunk (every attention call on its plain
    # version), and the fine refine step of frames 1-2 from a cold cache
    # (every attention call and K1 on their plain versions).
    sam = {}
    for plain in (False, True):
        kernel_auto = attention.flash_attention_auto
        if plain:
            attention.flash_attention_auto = plain_attention_auto
        try:
            sam[plain] = np.stack([high[0] > 0 for t, _, _, high in
                                   predictor.propagate_in_video(prompted(staged), max_frames=COUPLED_CHUNK + 1,
                                                                chunk=COUPLED_CHUNK)][1:])
        finally:
            attention.flash_attention_auto = kernel_auto
    sam_ious = mask_ious(sam[False], sam[True])
    refine_checks = [refine_kernels_vs_plain(est, extractor, "coupled", mesh, *per_frame[t][:2], k,
                                             per_frame[t][2], COUPLED_SCALE, torch.as_tensor(poses[t - 1], device=dev))
                     for t in (1, 2)]

    result = dict(frames=n, frame_hw=[h, w], chunk=COUPLED_CHUNK, batch_plan=plan, staged_frames=int(staged.frames.shape[0]),
                  stage_ms=stage_ms, run_s=run_s, launches=launches, sam2_graphs=sam2_graphs,
                  ms_per_frame=float(np.median(frame_ms[len(plan[0]):])),
                  sam2_ms_per_frame=float(np.median(sam_ms[len(plan[0]):])),
                  refine_ms_per_frame=float(np.median(refine_ms[1:])), refine_cold_frame_ms=refine_ms[1],
                  coarse_frame_ms=refine_ms[0], frame_ms=frame_ms, sam2_ms=sam_ms, refine_ms=refine_ms,
                  launches_per_frame=profile["coupled_video"]["launches"] / n,
                  device_busy_ms_per_frame=profile["coupled_video"]["device_busy_ms"] / n,
                  wall_ms_per_frame_profiled=profile["coupled_video"]["wall_ms"] / n,
                  h2d=h2d, h2d_bytes_per_frame=h2d["bytes"] / n,
                  masks_vs_propagate_in_video_mismatches=mask_mismatch, frames_equal_staged=frames_equal,
                  host_path=dict(crop_max_abs_err=max(x["crop_err"] for x in host),
                                 mask_crops_equal=all(x["cmask_equal"] for x in host),
                                 bboxes_equal=all(x["bbox_equal"] for x in host),
                                 mask_px=[x["mask_px"] for x in host], pose_max_abs_err=pose_err,
                                 score_max_abs_err=score_err),
                  inliers=run["inliers"].tolist(), threshold=run["thr"], inliers_equal_n_inliers_per_pose=inliers_equal,
                  misses_per_frame=run["chain"].miss_counts, full_redispatches=run["chain"].n_full_redispatch,
                  kernel_vs_plain={"sam2_mask_iou_frames_1_8": sam_ious.ravel().tolist(),
                                   "refine_frames_1_2": refine_checks},
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, profile=profile)
    log("coupled", **result)
    k2 = launches["K2_by_dim"]
    if min(launches["K1"], k2.get("64", 0), k2.get("72", 0), k2.get("256", 0), launches["K4"]) <= 0:
        raise AssertionError(f"coupled path did not launch every kernel: {launches}")
    if plan != [[0], list(range(1, COUPLED_CHUNK + 1)), list(range(COUPLED_CHUNK + 1, n))]:
        raise AssertionError(f"coupled path: batch plan {plan}")
    if mask_mismatch or not frames_equal:
        raise AssertionError(f"propagate_batched against propagate_in_video: {mask_mismatch} mask pixels differ, "
                             f"frames equal to the staged video: {frames_equal}")
    if not (result["host_path"]["crop_max_abs_err"] <= COUPLED_CROP_ATOL and result["host_path"]["mask_crops_equal"]
            and result["host_path"]["bboxes_equal"]):
        raise AssertionError(f"coupled crops against the host path: {result['host_path']}")
    if not (pose_err <= COUPLED_POSE_ATOL and score_err <= COUPLED_POSE_ATOL) or \
            not len(host_chain.results) == len(run["chain"].results) == n - 1:
        raise AssertionError(f"coupled chain against the host-fed chain: poses max abs err {pose_err}, scores "
                             f"{score_err}")
    if not inliers_equal:
        raise AssertionError(f"StreamingInliers {run['inliers'].tolist()} (threshold {run['thr']}) against "
                             f"n_inliers_per_pose {batch_inl.tolist()} ({batch_thr})")
    if sam_ious.min() < VIDEO_IOU_MIN:
        raise AssertionError(f"coupled SAM2 masks, kernels vs plain attention on frames 1-{COUPLED_CHUNK}: IoU "
                             f"{sam_ious}")
    for t, c in zip((1, 2), refine_checks):
        if c["render_mask_mismatches"] or not c["score_max_abs_err"] <= REFINE_SCORE_ATOL or \
                not c["one_slot_off_max_abs_err"] > REFINE_SCORE_ATOL or \
                min(c["launches"]["kernels"].values()) <= 0 or max(c["launches"]["plain"].values()) != 0:
            raise AssertionError(f"coupled refine frame {t}, kernels vs plain versions: {c}")
    return result, launches


STRIDE = 2  # memory_temporal_stride on the stride path


def held_memory_reference(t: int, cond: int, num_maskmem: int, r: int) -> set:
    """The memory frames a stride-r state holds after stepping frame t
    forward: the conditioning frame, the last frame, and the r-grid frames
    anchor - k·r (anchor = ((t+1-2)//r)·r) that the next frame attends,
    past the conditioning frame (the reference's selection, sam2_base.py)."""
    anchor = ((t - 1) // r) * r
    return {cond} | {f for f in {t} | {anchor - i * r for i in range(num_maskmem - 2)} if cond < f <= t}


def phase_stride(dev, stride1_ms_per_frame: float) -> tuple[dict, dict]:
    """SAM2 propagation with memory_temporal_stride = STRIDE at full width:
    Hiera-L at 1024², bf16, the object-score bias, both objects
    box-prompted on frame 0 of synthetic_video(), frame at a time. Gates:
    the memory frames held after every step equal the reference selection;
    each object's own mask, kernels vs plain attention on frames 1-9: mean
    IoU >= VIDEO_IOU_MIN, every IoU >= VOS_IOU_FLOOR."""
    import dataclasses

    from freepose_tpu_torch.models.sam2.predictor import Sam2VideoPredictor
    from freepose_tpu_torch.ops import attention
    from freepose_tpu_torch.scripts.common import production_sam2_video_config

    frames, boxes, _ = synthetic_video()
    cfg = production_sam2_video_config(dev)
    cfg = dataclasses.replace(cfg, mem=dataclasses.replace(cfg.mem, memory_temporal_stride=STRIDE))
    predictor = Sam2VideoPredictor(cfg, device=dev)
    held: list = []
    track_step = predictor.model.track_step

    def recording_step(state, *args, **kwargs):
        state, out = track_step(state, *args, **kwargs)
        frames_held = [{int(f) for f, v in zip(fr, va) if v} for fr, va in
                       zip(state.maskmem_frame.tolist(), state.maskmem_valid.tolist())]
        held.append((int(args[3]), frames_held))
        return state, out

    def propagate(plain: bool, record: bool):
        state = predictor.init_state(frames)
        for i, box in enumerate(boxes[0]):
            state = predictor.add_new_points_or_box(state, 0, obj_id=i, box=box)
        kernel_auto = attention.flash_attention_auto
        if plain:
            attention.flash_attention_auto = plain_attention_auto
        if record:
            predictor.model.track_step = recording_step
        highs, ms = [], []
        try:
            gen = predictor.propagate_in_video(state, chunk=1)
            while True:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                item = next(gen, None)
                if item is None:
                    break
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                highs.append(item[3] > 0)
        finally:
            attention.flash_attention_auto = kernel_auto
            if record:
                del predictor.model.track_step
        return np.stack(highs), ms

    torch.cuda.synchronize()
    reset_launches()
    high_k, frame_ms = propagate(plain=False, record=True)
    launches = read_launches()
    steps = list(held)
    high_p, _ = propagate(plain=True, record=False)
    frame_ms_again = propagate(plain=False, record=False)[1]
    nm = cfg.mem.num_maskmem
    held_ok = [all(h == held_memory_reference(t, 0, nm, STRIDE) for h in per_obj) for t, per_obj in steps]
    ious = mask_ious(high_k[1:], high_p[1:])  # [frames 1-9, objects]
    k2 = {str(d): launches["K2_by_dim"].get(str(d), 0) for d in (72, 256)}
    result = dict(stride=STRIDE, frames=len(frames), objects=int(boxes.shape[1]),
                  ms_per_frame=float(np.median(frame_ms[1:])),
                  ms_per_frame_again=float(np.median(frame_ms_again[1:])), prompt_frame_ms=frame_ms[0],
                  video_phase_stride1_ms_per_frame=stride1_ms_per_frame, frame_ms=frame_ms,
                  held_frames=[[t, sorted(per_obj[0])] for t, per_obj in steps], held_equal_reference=held_ok,
                  own_mask_iou_frames_1_9=ious.tolist(), own_mask_iou_mean=float(ious.mean()),
                  own_mask_iou_min=float(ious.min()), own_mask_px=high_k.sum(axis=(2, 3)).tolist(),
                  k2_launches_by_dim=k2, k4_launches=launches["K4"], launches=launches,
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log("stride", **result)
    if min(k2["72"], k2["256"], launches["K4"]) <= 0:
        raise AssertionError(f"stride path: kernel launches {launches}")
    if len(steps) != len(frames) or not all(held_ok):
        raise AssertionError(f"stride path: held memory frames {result['held_frames']} against the reference "
                             f"selection: {held_ok}")
    if ious.mean() < VIDEO_IOU_MIN or ious.min() < VOS_IOU_FLOOR:
        raise AssertionError(f"stride path, kernels vs plain attention on frames 1-9: own-mask IoU mean "
                             f"{ious.mean()}, min {ious.min()}")
    return result, launches


# The automatic mask generator at the reference's defaults (32 x 32 points,
# 64 per batch, multimask, box NMS 0.7), Hiera-L at 1024², bf16. With random
# weights the predicted IoUs and stability scores sit far below the
# defaults' 0.8 and 0.95, so the thresholds are taken from the candidates of
# a first pass: the predicted IoU halfway below the AMG_IOU_KEEP-th largest,
# the stability halfway below the AMG_STAB_KEEP-th largest of those left.
AMG_POINTS, AMG_BATCH, AMG_IOU_KEEP, AMG_STAB_KEEP, AMG_MAX_RECORDS = 32, 64, 600, 200, 500
AMG_SCORE_ATOL = 0.05


def threshold_keeping(values: np.ndarray, n_keep: int) -> float:
    """A threshold halfway between the n_keep-th largest value and the next
    smaller distinct one: the n_keep largest values pass (more where the
    n_keep-th ties with the next), and none sits on it."""
    v = np.sort(values.astype(np.float64))[::-1]
    below = v[min(n_keep, len(v)) - 1:]
    smaller = below[below < below[0]]
    if not smaller.size:
        raise AssertionError(f"no value below the {n_keep}-th largest of {len(v)}")
    return float((below[0] + smaller[0]) / 2)


def phase_amg(dev) -> tuple[dict, dict]:
    """Sam2AutomaticMaskGenerator on frame 0 of synthetic_video() at full
    width, with thresholds from a first pass's candidates; its time split
    into the image encoder, the decode batches and the host's filters, RLE
    and NMS."""
    from freepose_tpu_torch.geometry.boxes import nms_xyxy
    from freepose_tpu_torch.models.sam2.amg import batched_mask_to_box
    from freepose_tpu_torch.models.sam2.automatic import Sam2AutomaticMaskGenerator
    from freepose_tpu_torch.ops import attention
    from freepose_tpu_torch.scripts.common import load_sam2_image_predictor

    image = synthetic_video()[0][0]
    h, w = image.shape[:2]
    predictor = load_sam2_image_predictor(None, device=dev)
    probe = Sam2AutomaticMaskGenerator(predictor, points_per_side=AMG_POINTS, points_per_batch=AMG_BATCH)
    points = torch.as_tensor((probe.point_grids[0] * np.array([w, h])).astype(np.float32), device=dev)

    def candidates(plain: bool = False):
        """Every batch's pre-filter outputs (masks of batch 0 only)."""
        kernel_auto = attention.flash_attention_auto
        if plain:
            attention.flash_attention_auto = plain_attention_auto
        try:
            predictor.set_image(image)
            outs = [probe._decode(predictor._pyramid, points[s:s + AMG_BATCH], (h, w), True)
                    for s in range(0, len(points), AMG_BATCH)]
        finally:
            attention.flash_attention_auto = kernel_auto
        return (outs[0][0].cpu().numpy(), torch.cat([o[2] for o in outs]).cpu().numpy(),
                torch.cat([o[3] for o in outs]).cpu().numpy(), torch.cat([o[4] for o in outs]).cpu().numpy())

    masks0, iou, stab, cand_boxes = candidates()
    iou_thr = threshold_keeping(iou.ravel(), AMG_IOU_KEEP)
    stab_thr = threshold_keeping(stab[iou > iou_thr], AMG_STAB_KEEP)
    masks0_p, iou_p, stab_p, _ = candidates(plain=True)
    passing = (iou > iou_thr) & (stab >= stab_thr)
    ious0 = mask_ious(masks0, masks0_p)

    gen = Sam2AutomaticMaskGenerator(predictor, points_per_side=AMG_POINTS, points_per_batch=AMG_BATCH,
                                     pred_iou_thresh=iou_thr, stability_score_thresh=stab_thr)
    split = {"encoder": [], "decode": [], "batches": 0}
    set_image, decode, process_batch = predictor.set_image, gen._decode, gen._process_batch

    def timed(key, fn):
        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            split[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapped

    def counted(*args, **kwargs):
        split["batches"] += 1
        return process_batch(*args, **kwargs)

    torch.cuda.synchronize()
    reset_launches()
    predictor.set_image, gen._decode, gen._process_batch = timed("encoder", set_image), timed("decode", decode), counted
    try:
        t0 = time.perf_counter()
        records = gen.generate(image)
        split_s = time.perf_counter() - t0
    finally:
        predictor.set_image, gen._decode, gen._process_batch = set_image, decode, process_batch
    launches = read_launches()
    t0 = time.perf_counter()
    gen.generate(image)
    image_s = time.perf_counter() - t0
    profile = profile_device_time(lambda: gen.generate(image), "amg_image", top=12)

    masks = np.stack([r["segmentation"] for r in records]) if records else np.zeros((0, h, w), bool)
    area_ok = all(r["area"] == int(m.sum()) for r, m in zip(records, masks))
    boxes = batched_mask_to_box(torch.as_tensor(masks)).numpy().astype(np.float32)
    box_ok = all(r["bbox"] == [float(b[0]), float(b[1]), float(b[2] - b[0]), float(b[3] - b[1])]
                 for r, b in zip(records, boxes))
    xyxy = np.array([[r["bbox"][0], r["bbox"][1], r["bbox"][0] + r["bbox"][2], r["bbox"][1] + r["bbox"][3]]
                     for r in records], np.float32).reshape(-1, 4)
    nms_kept_all = len(nms_xyxy(xyxy, np.array([r["predicted_iou"] for r in records]), gen.box_nms_thresh)) == \
        len(records)
    encoder_ms, decode_ms = split["encoder"][0], float(np.sum(split["decode"]))
    k2 = launches["K2_by_dim"].get("72", 0)
    result = dict(image_hw=[h, w], points=AMG_POINTS ** 2, points_per_batch=AMG_BATCH, batches=split["batches"],
                  candidates=int(iou.size), pred_iou_thresh=iou_thr, stability_score_thresh=stab_thr,
                  candidates_passing_thresholds=int(passing.sum()),
                  distinct_boxes_passing=int(len(np.unique(cand_boxes[passing], axis=0))),
                  candidate_iou_range=[float(iou.min()), float(iou.max())],
                  candidate_stability_range=[float(stab.min()), float(stab.max())], records=len(records),
                  s_per_image=image_s, split_run_s=split_s, encoder_ms=encoder_ms, decode_ms=decode_ms,
                  decode_ms_per_batch=split["decode"], host_ms=split_s * 1e3 - encoder_ms - decode_ms,
                  kernel_vs_plain_batch0={"mask_iou_mean": float(ious0.mean()), "mask_iou_min": float(ious0.min()),
                                          "iou_pred_max_abs_err": float(np.abs(iou - iou_p)[:AMG_BATCH].max()),
                                          "stability_max_abs_err": float(np.abs(stab - stab_p)[:AMG_BATCH].max())},
                  areas_equal_mask_sums=area_ok, boxes_equal_mask_boxes=box_ok,
                  no_pair_above_nms=nms_kept_all, k2_d72_launches=k2, launches=launches,
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, profile=profile)
    log("amg", **result)
    if k2 <= 0:
        raise AssertionError(f"amg path: kernel launches {launches}")
    if split["batches"] != AMG_POINTS ** 2 // AMG_BATCH or not 1 <= len(records) <= AMG_MAX_RECORDS:
        raise AssertionError(f"amg path: {split['batches']} batches, {len(records)} records")
    kv = result["kernel_vs_plain_batch0"]
    if kv["mask_iou_mean"] < VIDEO_IOU_MIN or kv["iou_pred_max_abs_err"] > AMG_SCORE_ATOL or \
            kv["stability_max_abs_err"] > AMG_SCORE_ATOL:
        raise AssertionError(f"amg batch 0, kernels vs plain attention: {kv}")
    if not (area_ok and box_ok and nms_kept_all):
        raise AssertionError(f"amg records: RLE areas {area_ok}, boxes {box_ok}, NMS {nms_kept_all}")
    return result, launches


# Leftovers of slices B and D. The chain: the refine cell's widths (DINOv2-L
# layer 22 bf16, 420² renders, the 20,000-pose grid) with the 8 neighbours
# and 12 slots of the JAX package's chain test (capacity 12 < 3 regions x 8
# neighbours: hits, misses and evictions), lag 3. Chain against the serial
# loop: the same functions on the same card, bit-equal except where a
# speculative step's sums ran in another batch (none: both featurize the
# query crop alone). Batched intervals against the pipelined path on the
# card: the same per-interval chain, renders and EPnP inputs, set from the
# first run (PERF.md). The learned CoTracker on the card against the CPU: fp32
# convolutions (cuDNN, TF32 off, against oneDNN) and sums in another order,
# carried through 4 iterations of bilinear sampling; a run with one
# iteration fewer moves tracks by pixels and must fail it.
LEFT_NEIGHBORS, LEFT_CAPACITY, LEFT_LAG, LEFT_SCALE = 8, 12, 3, 0.25
LEFT_HIT_FRAMES = 16
BATCHED_POSE_ATOL = 1e-4
LEARNED_FRAMES, LEARNED_QUERIES, LEARNED_CUT = 12, 512, (2, 64)
LEARNED_TRACK_ATOL = 0.05  # pixels
VIS_FEATURE_FRAMES = 3


def leftover_trajectory(est) -> list[int]:
    """Grid indices of a 10-frame walk on the fine grid: g0, a neighbour g1
    of it, a neighbour g2 of g1 outside g0's neighbourhood, a neighbour g3
    of g2 outside g1's, and back; each pose held for two frames (all-hit
    speculation), each move a miss, the return after evictions."""
    from freepose_tpu_torch.pipeline.fine_cache import select_neighborhood_host

    rots = est.fine_poses[:, :3, :3].cpu().numpy()

    def near(g):
        return [int(i) for i in select_neighborhood_host(rots, rots[g], NEIGHBORHOOD, LEFT_NEIGHBORS)[0]]

    g0 = 5
    g1 = near(g0)[1]
    g2 = next(g for g in near(g1)[1:] if g not in near(g0))
    g3 = next(g for g in near(g2)[1:] if g not in near(g1))
    return [g0, g0, g1, g1, g2, g2, g3, g3, g2, g1]


def phase_leftovers(dev, mesh) -> tuple[dict, dict]:
    """The leftovers of slices B and D, each through the entry points a user
    calls: the serial refine_cached loop on a 10-frame walk of torus
    renders, smooth_track with
    batched_intervals=True on the smooth phase's frames, coarse rows and
    DINOv2-B, the learned CoTracker at its full widths on 12 frames of the
    video at 1280x720, and the vis_poses_video and vis_features CLIs on the
    video phase's frames (every row of the refine phase's CSV; DINOv2-L at
    518², layer 22); then each against its reference."""
    import contextlib
    import dataclasses
    import io

    import torch.nn.functional as F

    from freepose_tpu_torch.datasets.video import load_frame_dir, stage_frames_hbm
    from freepose_tpu_torch.geometry.camera import default_video_intrinsics
    from freepose_tpu_torch.io.bop_csv import read_results_csv
    from freepose_tpu_torch.io.mesh import load_obj, pad_mesh
    from freepose_tpu_torch.models.convert import random_cotracker_params, save_params
    from freepose_tpu_torch.models.cotracker import CoTrackerConfig, PointTracker
    from freepose_tpu_torch.models.dinov2 import VIT_B14_REG, VIT_L14_REG
    from freepose_tpu_torch.ops.attention import (bf16_error_bound, dense_attention, flash_attention_fn,
                                                  flash_attention_k2, sm90_key_tile)
    from freepose_tpu_torch.ops import rasterizer_cuda
    from freepose_tpu_torch.ops.rasterizer import RasterSettings, rasterize, rasterize_plain
    from freepose_tpu_torch.ops.rasterizer_cuda import prologue, raster_tile_plain
    from freepose_tpu_torch.ops.sampling import resize_bilinear
    from freepose_tpu_torch.pipeline.online_pose_estimator import AutoRefineChain, OnlinePoseEstimator
    from freepose_tpu_torch.pipeline.renderer import TemplateRenderer
    from freepose_tpu_torch.pipeline.template_bank import TemplateBank, normalize_feats
    from freepose_tpu_torch.pipeline.tracking_refiner import StreamingInliers, TrackingRefiner
    from freepose_tpu_torch.scripts import vis_features, vis_poses_video
    from freepose_tpu_torch.scripts.common import load_dino_extractor
    from freepose_tpu_torch.scripts.smooth_poses_video import smooth_track

    phase_t0 = time.perf_counter()
    for name, cfg, seed in (("dinov2.npz", VIT_L14_REG, SEED), ("dinov2_vitb.npz", VIT_B14_REG, SEED + 9)):
        if not (WORK_DIR / name).exists():
            save_params(random_dinov2_params(cfg, seed=seed), WORK_DIR / name)

    # The walk: an estimator at the refine cell's widths, its crops.
    extractor = load_dino_extractor(str(WORK_DIR / "dinov2.npz"), device=dev)

    def feature_fn(imgs):
        return extractor(imgs, layer=DINO_LAYER, feature_type="patch")

    renderer = TemplateRenderer(n_poses=N_VIEWS, device=dev)
    est = OnlinePoseEstimator(feature_fn, TemplateBank(feature_fn, renderer, cache_size=1, device=dev), renderer,
                              n_coarse_poses=N_VIEWS, n_fine_poses=N_FINE, n_neighbors=LEFT_NEIGHBORS,
                              extractor=extractor, feature_layer=DINO_LAYER, fine_cache_capacity=LEFT_CAPACITY)
    walk = leftover_trajectory(est)
    crops = []
    for gi in walk:
        rgb, depth = renderer.render_from_poses(mesh, est.fine_poses[gi][None])
        props, masks, boxes = renderer.generate_proposals(rgb, depth)
        crops.append((props[0], masks[0], boxes[0].float()))
    k_r, prev0 = renderer.k, est.fine_poses[walk[0]]

    # The smooth cell: the smooth phase's frames, coarse rows and mesh.
    frames_s = load_frame_dir(WORK_DIR / "smooth_frames")
    hs, ws_ = frames_s.shape[1:3]
    k_s = default_video_intrinsics(ws_, hs)
    coarse = sorted(read_results_csv(WORK_DIR / "coarse.csv", t_scale=1.0), key=lambda r: r.im_id)
    mesh_s = load_obj(WORK_DIR / "meshes" / str(coarse[0].obj_id) / f"{coarse[0].obj_id}.obj").normalized().scaled(
        coarse[0].scale)
    poses_s = np.stack([np.vstack([np.hstack([r.R, r.t[:, None]]), [0, 0, 0, 1]]) for r in coarse]).astype(np.float32)
    extractor_b = load_dino_extractor(str(WORK_DIR / "dinov2_vitb.npz"), model="vitb", device=dev)
    refiner = TrackingRefiner(feature_fn=lambda imgs: extractor_b(imgs, layer=None, feature_type="patch"),
                              tracker=PointTracker(device=dev), device=dev)
    staged = stage_frames_hbm(frames_s, device=dev)

    # The learned CoTracker: the video's 10 frames and 2 repeats of the last
    # (an interval padded to 12, as smooth_track pads), 512 seeded queries.
    video = synthetic_video()[0]
    video = np.concatenate([video, np.repeat(video[-1:], LEARNED_FRAMES - len(video), axis=0)])
    h, w = video.shape[1:3]
    rng = np.random.default_rng(SEED + 12)
    queries = np.stack([rng.uniform(0, w - 1, LEARNED_QUERIES), rng.uniform(0, h - 1, LEARNED_QUERIES)],
                       -1).astype(np.float32)
    ct_cfg = CoTrackerConfig()
    ct_params = random_cotracker_params(ct_cfg, seed=SEED + 12)
    learned = PointTracker(ct_cfg, params=ct_params, mode="learned", device=dev)

    # The viz CLIs' inputs: every row of the refine phase's CSV (both
    # tracks carry the torus's name, so a frame can hold two rows).
    shutil.copy(WORK_DIR / "chain.csv", WORK_DIR / "vis_rows.csv")
    images = [str(p) for p in sorted((WORK_DIR / "frames").glob("*.png"))[:VIS_FEATURE_FRAMES]]
    vis_poses_argv = ["--video-dir", str(WORK_DIR / "frames"), "--poses", str(WORK_DIR / "vis_rows.csv"),
                      "--mesh-dir", str(WORK_DIR / "meshes"), "--out-dir", str(WORK_DIR / "overlays"),
                      "--device", str(dev)]
    vis_features_argv = ["--images", *images, "--out", str(WORK_DIR / "feature_panels"),
                         "--weights", str(WORK_DIR / "dinov2.npz"), "--layer", str(DINO_LAYER), "--device", str(dev)]
    cli_out = io.StringIO()

    def run_smooth(**kw):
        return smooth_track(refiner, mesh_s, staged, k_s, poses_s, interval=12, cap=512, **kw)

    # The path, once, with the launch counts.
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    serial, prev = [], prev0
    for crop, cmask, bbox in crops:
        o = est.refine_cached(crop, cmask, mesh, k_r, bbox, LEFT_SCALE, prev, NEIGHBORHOOD, cache_key="serial")
        serial.append((o.tcos[0].cpu().numpy(), float(o.scores[0])))
        prev = o.tcos[0]
    walk_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    batched, batched_inliers = run_smooth(batched_intervals=True)
    batched_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with torch.inference_mode():
        tracks, vis = learned.model(learned._video(video), learned._queries(queries), 0)
    torch.cuda.synchronize()
    learned_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(cli_out):
        vis_poses_video.main(vis_poses_argv)
    torch.cuda.synchronize()
    vis_poses_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(cli_out):
        vis_features.main(vis_features_argv)
    torch.cuda.synchronize()
    vis_features_s = time.perf_counter() - t0
    launches = read_launches()

    # One refine step from the walk's frame 1 pose, kernels against plain.
    refine_check = refine_kernels_vs_plain(est, extractor, "serial", mesh, *crops[2][:2], k_r, crops[2][2],
                                           LEFT_SCALE, torch.as_tensor(serial[1][0], device=dev))

    # ms per hit frame, each timed to the card's finish: the device-cache
    # chain and the serial loop, after one seeding frame.
    def hit_run(kind):
        crop, cmask, bbox = crops[0]
        key = f"timing_{kind}"
        if kind == "serial":
            def step(prev):
                o = est.refine_cached(crop, cmask, mesh, k_r, bbox, LEFT_SCALE, prev, NEIGHBORHOOD, cache_key=key)
                return o.tcos[0].cpu().numpy()
            prev = step(prev0)
        else:
            runner = AutoRefineChain(est, mesh, key, neighborhood_deg=NEIGHBORHOOD, lag=LEFT_LAG,
                                     miss_bucket=LEFT_NEIGHBORS)
            runner.submit(crop, cmask, k_r, bbox, LEFT_SCALE, prev_pose=prev0)
            runner.finalize_all()
        torch.cuda.synchronize()
        before = read_launches()
        t0 = time.perf_counter()
        for _ in range(LEFT_HIT_FRAMES):
            if kind == "serial":
                prev = step(prev)
            else:
                runner.submit(crop, cmask, k_r, bbox, LEFT_SCALE)
        if kind != "serial":
            runner.finalize_all()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / LEFT_HIT_FRAMES
        after = read_launches()
        out = {"ms_per_frame": ms,
               "launches_per_frame": {key_: (after[key_] - before[key_]) / LEFT_HIT_FRAMES for key_ in ("K1", "K2")}}
        if kind == "auto":
            out["misses"] = sum(runner.miss_counts[1:])
        return out

    hit_frames = {kind: hit_run(kind) for kind in ("auto", "serial")}

    # Batched intervals against the pipelined path; StreamingInliers' counts
    # through inliers= against the path that computes them.
    def timed_s(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (pipelined, pipelined_inliers), pipelined_s = timed_s(lambda: run_smooth())
    _, batched_warm_s = timed_s(lambda: run_smooth(batched_intervals=True))
    stream = StreamingInliers(refiner, mesh_s, staged, k_s, chunk=SMOOTH_CHUNK)
    for t, pose in enumerate(poses_s):
        stream.add(t, pose)
    stream_counts, _ = stream.finalize()
    fed, _ = run_smooth(inliers=stream_counts)
    n_s = staged.n
    batched_check = dict(frames=n_s, staged_frames=int(staged.frames.shape[0]),
                         interval_bucket=-(-(int(staged.frames.shape[0]) // 12 + 2) // 4) * 4,
                         starts=len(set(range(int(np.argmax(batched_inliers)), n_s, 12))
                                    | set(range(int(np.argmax(batched_inliers)), -1, -12))),
                         pose_max_abs_err=float(np.abs(batched - pipelined).max()), atol=BATCHED_POSE_ATOL,
                         inliers_equal=bool(np.array_equal(batched_inliers, pipelined_inliers)),
                         streaming_inliers=stream_counts.tolist(),
                         streaming_equal_computed=bool(np.array_equal(stream_counts, pipelined_inliers)),
                         inliers_rows_identical=bool(np.array_equal(fed, pipelined)),
                         ms_per_video={"batched": batched_warm_s * 1e3, "pipelined": pipelined_s * 1e3},
                         first_run_s=batched_s)

    # The learned CoTracker: gates on the path's run, its time and busy
    # share, and a cut of its inputs on the card against the CPU.
    tracks_np, vis_np = tracks.cpu().numpy(), vis.cpu().numpy()
    _, learned_ms = timed_s(lambda: learned.track(video, queries, 0))
    learned_profile = profile_device_time(lambda: learned.track(video, queries, 0), "learned_interval", top=10)
    n_cut, q_cut = LEARNED_CUT
    cut = {}
    for name, device, cfg in (("card", dev, ct_cfg), ("cpu", torch.device("cpu"), ct_cfg),
                              ("cpu_one_iteration_fewer", torch.device("cpu"),
                               dataclasses.replace(ct_cfg, n_iters=ct_cfg.n_iters - 1))):
        tracker = learned if name == "card" else PointTracker(cfg, params=ct_params, mode="learned", device=device)
        with torch.inference_mode():
            cut[name] = tracker.model(tracker._video(video[:n_cut]), tracker._queries(queries[:q_cut]), 0)[0].cpu()
    learned_check = dict(frames=LEARNED_FRAMES, frame_hw=[h, w], queries=LEARNED_QUERIES,
                         config=dataclasses.asdict(ct_cfg) | {"dtype": str(ct_cfg.dtype)},
                         tracks_finite=bool(np.isfinite(tracks_np).all()),
                         query_frame_pinned=bool(np.array_equal(tracks_np[0], queries)),
                         vis_range=[float(vis_np.min()), float(vis_np.max())],
                         visible_share=float((vis_np > 0.5).mean()),
                         track_extent_px=float(np.abs(tracks_np - queries[None]).max()),
                         ms_per_interval=learned_ms * 1e3, first_run_s=learned_s,
                         cut=[n_cut, q_cut], cut_card_vs_cpu_max_abs_px=float((cut["card"] - cut["cpu"]).abs().max()),
                         cut_one_iteration_fewer_max_abs_px=float(
                             (cut["cpu_one_iteration_fewer"] - cut["cpu"]).abs().max()),
                         atol_px=LEARNED_TRACK_ATOL)

    # vis_poses_video: one overlay per distinct frame, every row in its K1
    # call, which is held against the plain rasterizer.
    vis_rows = sorted(read_results_csv(WORK_DIR / "vis_rows.csv", t_scale=1.0), key=lambda r: r.im_id)
    hv, wv = load_frame_dir(WORK_DIR / "frames").shape[1:3]
    vmesh = load_obj(WORK_DIR / "meshes" / str(vis_rows[0].obj_id) / f"{vis_rows[0].obj_id}.obj").normalized().scaled(
        vis_rows[0].scale)
    vargs = [torch.as_tensor(x, device=dev) for x in pad_mesh(vmesh, 16384, 32768)]
    vposes = torch.as_tensor(np.stack([np.vstack([np.hstack([r.R, r.t[:, None]]), [0, 0, 0, 1]]) for r in vis_rows]),
                             dtype=torch.float32, device=dev)
    vscale = 480 / max(hv, wv)
    vk = torch.as_tensor(default_video_intrinsics(wv, hv).numpy() * np.array([[vscale], [vscale], [1]]),
                         dtype=torch.float32, device=dev)
    vsettings = RasterSettings(resolution=480, tile=32, max_faces_per_tile=256)
    _, vdepth = rasterize(*vargs, vposes, vk, vsettings)
    _, vdepth_plain = rasterize_plain(*vargs, vposes, vk, vsettings)
    # K1 alone at this shape, from the call's prologue: times and bound.
    vrows, vslots = prologue(*vargs, vposes, vk.expand(len(vposes), 3, 3), vsettings)
    kb = k1_bound(vrows, vslots, vsettings.resolution, vsettings.tile, False)

    def k1_at(fn):
        return fn(vrows, vslots, vsettings.resolution, vsettings.tile, vsettings.ambient, False)

    def k1_kernel():
        return k1_at(rasterizer_cuda.raster_tile)

    k1_480 = {"poses": int(vrows.shape[0]), "tiles": int(vslots.shape[1]), "faces_per_tile": int(vslots.shape[2]),
              "hit_mask_mismatches": int(((k1_kernel()[..., 0] > 0) != (k1_at(raster_tile_plain)[..., 0] > 0)).sum()),
              "ms": cuda_ms(k1_kernel, reps=10), "device_ms": device_ms(k1_kernel),
              "plain_ms": cuda_ms(lambda: k1_at(raster_tile_plain), reps=1), "bound_ms": kb["bound_ms"],
              "bound_by": kb["bound_by"]}
    del vrows, vslots
    overlays = sorted((WORK_DIR / "overlays").glob("*.jpg"))
    vis_frames = sorted({r.im_id for r in vis_rows})
    vis_poses_check = dict(rows=len(vis_rows), frames=len(vis_frames), overlays=len(overlays),
                           poses=int(vposes.shape[0]),
                           frame_ids_equal=[p.stem for p in overlays] == [f"{i:06d}" for i in vis_frames],
                           k1_hit_mask_mismatches=int(((vdepth > 0) != (vdepth_plain > 0)).sum()),
                           k1_depth_max_err=float((vdepth - vdepth_plain).abs().max()), atol=K1_ATOL,
                           hit_px=int((vdepth > 0).sum()), cli_s=vis_poses_s,
                           ms_per_row=vis_poses_s * 1e3 / len(vis_rows),
                           k1_call_ms=cuda_ms(lambda: rasterize(*vargs, vposes, vk, vsettings), reps=5), k1_480=k1_480)
    del vdepth, vdepth_plain

    # vis_features: the panels, and the CLI's features (the walk's
    # extractor: the same weights and config) with K2 against every
    # attention call on its plain version on the same resized frames.
    from PIL import Image

    panels = sorted((WORK_DIR / "feature_panels").glob("*_feats.png"))
    fe = extractor
    size = fe.config.image_size
    squares = torch.stack([
        resize_bilinear(torch.as_tensor(np.array(Image.open(p).convert("RGB")), dtype=torch.float32,
                                        device=dev).permute(2, 0, 1), (size, size)) for p in images]) / 255.0
    feats = {}
    for plain in (False, True):
        for blk in fe.model.blocks:
            blk.attn.attention_fn = dense_attention if plain else flash_attention_fn
        with torch.inference_mode():
            feats[plain] = torch.cat([normalize_feats(fe(s[None], layer=DINO_LAYER, feature_type="patch").float())
                                      for s in squares])
    for blk in fe.model.blocks:
        blk.attn.attention_fn = flash_attention_fn
    panel_shapes = [list(np.asarray(Image.open(p)).shape) for p in panels]
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    cfg_l = VIT_L14_REG
    heads, d = cfg_l.num_heads, cfg_l.hidden_size // cfg_l.num_heads
    ntok = 1 + cfg_l.num_registers + cfg_l.native_grid ** 2
    q, kk, v = (torch.randn((1, heads, ntok, d), generator=gen, device=dev) for _ in range(3))
    q, kk, v = (q * QUERY_STD).to(torch.bfloat16), kk.to(torch.bfloat16), v.to(torch.bfloat16)
    scale = d ** -0.5
    ref = dense_attention(q, kk, v, scale)
    k2 = check_attention(flash_attention_k2(q, kk, v, scale), ref, bf16_error_bound(q, kk, v, scale, ref), {
        "drops_last_keys": dense_attention(q, kk[:, :, :-DROPPED_KEYS], v[:, :, :-DROPPED_KEYS], scale),
        "reads_next_head": reads_next_head(q, kk, v, scale, sm90_key_tile(d))})
    k2_bound, k2_bound_by = bound(4 * heads * ntok * ntok * d, 4 * heads * ntok * d * 2)
    vis_features_check = dict(images=len(images), panels=len(panels), panel_shapes=panel_shapes,
                              feature_cos_min=float((feats[False] * feats[True]).sum(-1).min()),
                              feature_cos_floor=FEATURE_COS_MIN, cli_s=vis_features_s,
                              k2_1374={"shape": [1, heads, ntok, d], **k2, "tol": ATTN_TOL,
                                       "ms": cuda_ms(lambda: flash_attention_k2(q, kk, v, scale), reps=20),
                                       "device_ms": device_ms(lambda: flash_attention_k2(q, kk, v, scale)),
                                       "plain_ms": cuda_ms(lambda: dense_attention(q, kk, v, scale), reps=5),
                                       "sdpa_ms": cuda_ms(lambda: F.scaled_dot_product_attention(q, kk, v, scale=scale),
                                                          reps=20),
                                       "sdpa_device_ms": device_ms(lambda: F.scaled_dot_product_attention(
                                           q, kk, v, scale=scale)),
                                       "bound_ms": k2_bound, "bound_by": k2_bound_by})
    del q, kk, v, ref, feats

    result = dict(launches=launches, walk=walk, walk_s=walk_s, refine_kernels_vs_plain=refine_check,
                  hit_frames=hit_frames, batched_intervals=batched_check, learned_cotracker=learned_check,
                  learned_profile=learned_profile, vis_poses_video=vis_poses_check,
                  vis_features=vis_features_check, cli_last_lines=cli_out.getvalue().strip().splitlines()[-2:],
                  phase_s=time.perf_counter() - phase_t0, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log("leftovers", **result)
    if min(launches["K1"], launches["K2_by_dim"].get("64", 0)) <= 0:
        raise AssertionError(f"leftovers path did not launch K1 and K2 at d 64: {launches}")
    if refine_check["render_mask_mismatches"] or not refine_check["score_max_abs_err"] <= REFINE_SCORE_ATOL or \
            not refine_check["one_slot_off_max_abs_err"] > REFINE_SCORE_ATOL or \
            min(refine_check["launches"]["kernels"].values()) <= 0 or \
            max(refine_check["launches"]["plain"].values()) != 0:
        raise AssertionError(f"leftovers refine step, kernels vs plain versions: {refine_check}")
    b = batched_check
    if not (b["pose_max_abs_err"] <= BATCHED_POSE_ATOL and b["inliers_equal"] and b["streaming_equal_computed"]
            and b["inliers_rows_identical"]):
        raise AssertionError(f"batched intervals and inliers= against the pipelined path: {b}")
    lc = learned_check
    if not (lc["tracks_finite"] and lc["query_frame_pinned"] and 0.0 <= lc["vis_range"][0]
            and lc["vis_range"][1] <= 1.0 and lc["cut_card_vs_cpu_max_abs_px"] <= LEARNED_TRACK_ATOL
            and lc["cut_one_iteration_fewer_max_abs_px"] > LEARNED_TRACK_ATOL):
        raise AssertionError(f"learned CoTracker: {lc}")
    vp = vis_poses_check
    if not (vp["overlays"] == vp["frames"] > 0 and vp["poses"] == vp["rows"] and vp["frame_ids_equal"]
            and vp["k1_hit_mask_mismatches"] == 0 and vp["k1_depth_max_err"] <= K1_ATOL
            and k1_480["hit_mask_mismatches"] == 0):
        raise AssertionError(f"vis_poses_video: {vp}")
    vf = vis_features_check
    if not (vf["panels"] == vf["images"] == VIS_FEATURE_FRAMES and vf["feature_cos_min"] >= FEATURE_COS_MIN):
        raise AssertionError(f"vis_features: {vf}")
    return result, launches


MESH_TOPK_ROWS, MESH_TOPK_QUERIES, MESH_TOPK_K = 46037, 16, 10
MESH_TOPK_ATOL = MESH_POSE_ATOL = 1e-5
MESH_CLI_T_ATOL = 1e-4  # the CSV's translations, as the CPU CLI tests hold them
MESH_SAM2_IOU_MIN = 0.99
MESH_SAM2_LOGIT_ATOL = 1.0  # the video and vos phases' low-res logit limit
MESH_REPS = 10


def drops_shard_offset(bank_shards, queries, k, mesh):
    """topk_search_sharded without the shards' row offsets: each shard's
    local indices go into the global top-k as they are. The stand-in the
    top-k gate must fail."""
    from freepose_tpu_torch.ops.knn import topk_lowest_index, topk_search
    from freepose_tpu_torch.parallel.mesh import gather

    rows = bank_shards[0].shape[0]
    parts = [topk_search(shard, queries.to(shard.device), min(k, rows)) for shard in bank_shards]
    s_all = gather([s.T for s, _ in parts], mesh).T
    i_all = gather([i.T for _, i in parts], mesh).T
    top, pos = topk_lowest_index(s_all, k)
    return top, torch.take_along_dim(i_all, pos, dim=1)


def mesh_topk(mesh, dev) -> dict:
    """(a): the sharded top-k over a seeded, normalised 46,037 x 1,024 bank
    against topk_search on the whole bank, the offset-dropping stand-in,
    and both times."""
    from freepose_tpu_torch.ops.knn import topk_search, topk_search_sharded
    from freepose_tpu_torch.parallel.mesh import shard_bank

    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    bank = torch.randn((MESH_TOPK_ROWS, BANK_DIM), generator=gen, device=dev)
    bank /= bank.norm(dim=-1, keepdim=True)
    q = torch.randn((MESH_TOPK_QUERIES, BANK_DIM), generator=gen, device=dev)
    q /= q.norm(dim=-1, keepdim=True)
    shards = shard_bank(bank, mesh)

    def sharded():
        return topk_search_sharded(shards, q, MESH_TOPK_K, mesh)

    s, i = sharded()
    s1, i1 = topk_search(bank, q, MESH_TOPK_K)
    _, io = drops_shard_offset(shards, q, MESH_TOPK_K, mesh)
    out = dict(rows=MESH_TOPK_ROWS, padded_rows=sum(int(x.shape[0]) for x in shards), shards=len(shards),
               shard_devices=[str(x.device) for x in shards], queries=MESH_TOPK_QUERIES, k=MESH_TOPK_K,
               indices_identical=bool(torch.equal(i.cpu(), i1.cpu())),
               score_max_abs_err=float((s.cpu() - s1.cpu()).abs().max()), atol=MESH_TOPK_ATOL,
               offset_dropped_indices_identical=bool(torch.equal(io.cpu(), i1.cpu())),
               offset_dropped_wrong_rows=int((io.cpu() != i1.cpu()).sum()),
               ms=cuda_ms(sharded, reps=MESH_REPS), whole_bank_ms=cuda_ms(lambda: topk_search(bank, q, MESH_TOPK_K),
                                                                          reps=MESH_REPS))
    del bank, shards
    return out


def mesh_refine(est, torus, crop, cmask, bbox, prev, mesh) -> dict:
    """(b): refine_sharded against refine() on the same frame: the 32
    rescored views (render masks, scores), the lifted pose, the shards
    reassembled in reverse order (which must fail), and ms per frame of
    both, in turns."""
    from freepose_tpu_torch.pipeline import online_pose_estimator as ope
    from freepose_tpu_torch.parallel.mesh import gather

    r = est.renderer
    qf = est.coarse.query_features(crop)
    v, c, f, fv = r._padded(torus, est.rendering_scale)
    args = (est.fine_poses, prev, NEIGHBORHOOD, v, c, f, fv, r.k, r.settings, est.n_neighbors, r.pose_chunk,
            r.resolution, est.extractor, DINO_LAYER)
    grid = r.resolution // est.extractor.config.patch_size

    def scored(prep):
        return prep[4], ope.rescore_views(prep[3], qf, prep[2], prep[4], cmask, grid, False)

    masks1, scores1 = scored(ope._refine_prepare_fused(*args))
    masks_s, scores_s = scored(ope._refine_prepare_fused_sharded(*args, mesh, "model"))
    ope.gather = lambda parts, m: gather(parts[::-1], m)
    try:
        masks_r, scores_r = scored(ope._refine_prepare_fused_sharded(*args, mesh, "model"))
    finally:
        ope.gather = gather
    valid = torch.isfinite(scores1)

    def score_err(x):
        if not torch.equal(torch.isfinite(x), valid):
            return float("inf")
        return float((x[valid] - scores1[valid]).abs().max())

    refine_args = (qf, cmask, torus, r.k, bbox, LEFT_SCALE, prev, NEIGHBORHOOD)
    one = est.refine(*refine_args)
    sh = est.refine_sharded(*refine_args[:7], device_mesh=mesh, neighborhood_deg=NEIGHBORHOOD)
    # One shard's block alone: its launches.
    per_shard = est.n_neighbors // mesh.shape["model"]
    torch.cuda.synchronize()
    before = read_launches()
    ope._render_and_featurize(v, c, f, fv, r.k, est.fine_poses[:per_shard], r.settings, r.pose_chunk, r.resolution,
                              est.extractor, DINO_LAYER, False)
    torch.cuda.synchronize()
    after = read_launches()

    def frame_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MESH_REPS):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / MESH_REPS

    timed = {"sharded": [], "unsharded": []}
    for kind in ("unsharded", "sharded", "sharded", "unsharded"):
        timed[kind].append(frame_ms(lambda: est.refine(*refine_args)) if kind == "unsharded" else
                           frame_ms(lambda: est.refine_sharded(*refine_args[:7], device_mesh=mesh,
                                                               neighborhood_deg=NEIGHBORHOOD)))
    return dict(mesh=mesh.shape, views=est.n_neighbors, views_per_shard=per_shard,
                valid_views=int(valid.sum()),
                render_mask_mismatches=int((masks_s != masks1).sum()), score_max_abs_err=score_err(scores_s),
                score_atol=REFINE_SCORE_ATOL,
                reversed_render_mask_mismatches=int((masks_r != masks1).sum()),
                reversed_score_max_abs_err=score_err(scores_r),
                pose_max_abs_err=float((sh.tcos - one.tcos).abs().max()), pose_atol=MESH_POSE_ATOL,
                view_index_equal=int(sh.view_indices) == int(one.view_indices),
                launches_per_shard={k: after[k] - before[k] for k in ("K1", "K2")},
                ms_per_frame={k: float(np.mean(x)) for k, x in timed.items()}, ms_in_turns=timed)


def phase_mesh(dev, torus) -> tuple[dict, dict]:
    """The multi-GPU paths on four shards of the one card, each through the
    entry points a user calls, then each against its unsharded version on
    the same card (docstring, phase 19)."""
    import contextlib
    import io

    from freepose_tpu_torch.datasets.video import load_frame_dir, stage_frames_hbm
    from freepose_tpu_torch.geometry.camera import default_video_intrinsics
    from freepose_tpu_torch.io.bop_csv import read_results_csv
    from freepose_tpu_torch.io.mesh import load_obj
    from freepose_tpu_torch.models.cotracker import PointTracker
    from freepose_tpu_torch.models.convert import random_sam2_video_params
    from freepose_tpu_torch.models.sam2.predictor import Sam2VideoPredictor
    from freepose_tpu_torch.parallel.mesh import make_mesh
    from freepose_tpu_torch.pipeline.online_pose_estimator import OnlinePoseEstimator
    from freepose_tpu_torch.pipeline.renderer import TemplateRenderer
    from freepose_tpu_torch.pipeline.template_bank import TemplateBank
    from freepose_tpu_torch.pipeline.tracking_refiner import TrackingRefiner
    from freepose_tpu_torch.scripts import dino_inference_video, extract_proposals_ground_video
    from freepose_tpu_torch.scripts.common import load_dino_extractor, production_sam2_video_config
    from freepose_tpu_torch.scripts.smooth_poses_video import smooth_track

    phase_t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    mesh = make_mesh(data=2, model=2, devices=[dev] * 4)
    mesh_1x4 = make_mesh(data=1, model=4, devices=[dev] * 4)
    mesh_info = dict(shape=mesh.shape, devices=[str(d) for d in mesh.devices],
                     distinct_devices=len(mesh.distinct_devices), first=str(mesh.first))

    # (b), (c): an estimator at the refine cell's widths, and the leftovers
    # walk's estimators (8 neighbours, 12 slots), unsharded and sharded.
    extractor = load_dino_extractor(str(WORK_DIR / "dinov2.npz"), device=dev)

    def feature_fn(imgs):
        return extractor(imgs, layer=DINO_LAYER, feature_type="patch")

    renderer = TemplateRenderer(n_poses=N_VIEWS, device=dev)
    bank = TemplateBank(feature_fn, renderer, cache_size=1, device=dev)

    def estimator(n_neighbors, cap=0, shard_mesh=None):
        return OnlinePoseEstimator(feature_fn, bank, renderer, n_coarse_poses=N_VIEWS, n_fine_poses=N_FINE,
                                   n_neighbors=n_neighbors, extractor=extractor, feature_layer=DINO_LAYER,
                                   fine_cache_capacity=cap, shard_mesh=shard_mesh)

    est = estimator(N_NEIGHBORS)
    walk_est, walk_sharded = estimator(LEFT_NEIGHBORS, LEFT_CAPACITY), estimator(LEFT_NEIGHBORS, LEFT_CAPACITY, mesh)
    walk = leftover_trajectory(walk_est)
    crops = []
    for gi in walk:
        rgb, depth = renderer.render_from_poses(torus, est.fine_poses[gi][None])
        props, masks, boxes = renderer.generate_proposals(rgb, depth)
        crops.append((props[0], masks[0], boxes[0].float()))
    k_r = renderer.k
    prevs = [est.fine_poses[walk[0]]] + [est.fine_poses[g] for g in walk[:-1]]

    # (d): SAM2 on the video cell's frames and boxes, one parameter tree.
    frames_v = load_frame_dir(WORK_DIR / "frames")
    boxes0 = np.load(WORK_DIR / "boxes.npy")
    sam_cfg = production_sam2_video_config(dev)
    sam_params = random_sam2_video_params(sam_cfg, seed=SEED)
    sam_sharded = Sam2VideoPredictor(sam_cfg, sam_params, device_mesh=mesh)
    sam_base = Sam2VideoPredictor(sam_cfg, sam_params, device=dev)
    del sam_params

    def propagate(pred, objects=range(len(boxes0))):
        state = pred.init_state(frames_v)
        for i in objects:
            state = pred.add_new_points_or_box(state, 0, obj_id=i, box=boxes0[i])
        out, ms = [], []
        gen = pred.propagate_in_video(state, chunk=1)
        while True:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            item = next(gen, None)
            if item is None:
                break
            ms.append((time.perf_counter() - t0) * 1e3)
            out.append((item[2], item[3]))
        return out, ms

    # (e): the smooth cell, its refiner with the extractor it replicates.
    frames_s = load_frame_dir(WORK_DIR / "smooth_frames")
    hs, ws_ = frames_s.shape[1:3]
    k_s = default_video_intrinsics(ws_, hs)
    coarse = sorted(read_results_csv(WORK_DIR / "coarse.csv", t_scale=1.0), key=lambda r: r.im_id)
    mesh_s = load_obj(WORK_DIR / "meshes" / str(coarse[0].obj_id) / f"{coarse[0].obj_id}.obj").normalized().scaled(
        coarse[0].scale)
    poses_s = np.stack([np.vstack([np.hstack([r.R, r.t[:, None]]), [0, 0, 0, 1]]) for r in coarse]).astype(np.float32)
    extractor_b = load_dino_extractor(str(WORK_DIR / "dinov2_vitb.npz"), model="vitb", device=dev)
    refiner = TrackingRefiner(feature_fn=lambda imgs: extractor_b(imgs, layer=None, feature_type="patch"),
                              tracker=PointTracker(device=dev), device=dev, extractor=extractor_b, feature_layer=None)
    staged = stage_frames_hbm(frames_s, device=dev)

    # (f): the CLIs' arguments as the refine and video phases ran them.
    refine_argv = ["--video-dir", str(WORK_DIR / "frames"), "--proposals", str(WORK_DIR / "scaled.json"),
                   "--wds-dir", str(WORK_DIR / "shards"), "--weights", str(WORK_DIR / "dinov2.npz"),
                   "--layer", str(DINO_LAYER), "--filelist", str(WORK_DIR / "refine_meshes.txt"),
                   "--mesh-dir", str(WORK_DIR / "meshes"), "--device", str(dev)]
    video_argv = ["--video-dir", str(WORK_DIR / "frames"), "--bank", str(WORK_DIR / "bank.npy"),
                  "--filelist", str(WORK_DIR / "filelist.txt"), "--detector", "boxes",
                  "--boxes", str(WORK_DIR / "boxes.npy"), "--layer", str(DINO_LAYER),
                  "--min-mask-px", str(MIN_MASK_PX), "--device", str(dev)]
    cli_out = io.StringIO()
    crop, cmask, bbox = crops[2]
    setup_s = time.perf_counter() - phase_t0

    # The path, once, with the launch counts.
    torch.cuda.synchronize()
    reset_launches()
    t_path = time.perf_counter()
    topk = mesh_topk(mesh, dev)
    sharded_refine = est.refine_sharded(est.coarse.query_features(crop), cmask, torus, k_r, bbox, LEFT_SCALE,
                                        prevs[2], device_mesh=mesh, neighborhood_deg=NEIGHBORHOOD)
    walk_rows = [walk_sharded.refine_cached(cr, cm, torus, k_r, bb, LEFT_SCALE, pv, NEIGHBORHOOD, cache_key="walk")
                 for (cr, cm, bb), pv in zip(crops, prevs)]
    sam_out, sam_ms = propagate(sam_sharded)
    smooth_rows, smooth_inliers = smooth_track(refiner, mesh_s, staged, k_s, poses_s, interval=12, cap=512,
                                               device_mesh=mesh)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(cli_out):
        dino_inference_video.main([*refine_argv, "--shard-refine", "--out", str(WORK_DIR / "mesh_shard.csv")])
    torch.cuda.synchronize()
    refine_cli_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(cli_out):
        extract_proposals_ground_video.main([*video_argv, "--shard-objects",
                                             "--out", str(WORK_DIR / "mesh_proposals.json")])
    torch.cuda.synchronize()
    video_cli_s = time.perf_counter() - t0
    path_s = time.perf_counter() - t_path
    launches = read_launches()
    assert sharded_refine.tcos.shape == (1, 4, 4)

    # (b) against refine() on this mesh and on the 1 x 4 mesh.
    refine_checks = {"2x2": mesh_refine(est, torus, crop, cmask, bbox, prevs[2], mesh),
                     "1x4": mesh_refine(est, torus, crop, cmask, bbox, prevs[2], mesh_1x4)}

    # (c) against the unsharded cached refine on the same frames and prevs.
    plain_rows = [walk_est.refine_cached(cr, cm, torus, k_r, bb, LEFT_SCALE, pv, NEIGHBORHOOD, cache_key="walk")
                  for (cr, cm, bb), pv in zip(crops, prevs)]
    cache_s, cache_p = walk_sharded._fine_caches["walk"], walk_est._fine_caches["walk"]
    cached_check = dict(walk=walk, rows=len(walk_rows),
                        pose_max_abs_err=max(float((a.tcos - b.tcos).abs().max()) for a, b in zip(walk_rows, plain_rows)),
                        score_max_abs_err=max(float((a.scores - b.scores).abs().max())
                                              for a, b in zip(walk_rows, plain_rows)),
                        view_indices_equal=all(int(a.view_indices) == int(b.view_indices)
                                               for a, b in zip(walk_rows, plain_rows)),
                        slot_of_equal=cache_s.slot_of == cache_p.slot_of, lru_equal=list(cache_s.lru) == list(cache_p.lru),
                        cached_views=len(cache_s.slot_of), pose_atol=MESH_POSE_ATOL, score_atol=REFINE_SCORE_ATOL)

    # (d) against the unsharded predictor, at each shard's batch (one
    # object: each alone) and at the whole batch (both objects). bf16
    # kernels and GEMMs round otherwise at another object count, and with
    # random weights many logits sit near 0, so the whole batch is held
    # apart: the unsharded predictor against itself at the two batch sizes
    # shows how far that alone moves the masks.
    def agreement(run, ref):
        ious, low_err, bit_equal = [], 0.0, True
        for (low_a, high_a), (low_b, high_b) in zip(run, ref):
            for o in range(len(boxes0)):
                a, b = high_a[o] > 0, high_b[o] > 0
                union = int((a | b).sum())
                ious.append(1.0 if union == 0 else int((a & b).sum()) / union)
            low_err = max(low_err, float(np.abs(low_a - low_b).max()))
            bit_equal &= bool(np.array_equal(low_a, low_b) and np.array_equal(high_a, high_b))
        return dict(iou_min=min(ious), iou_mean=float(np.mean(ious)), low_res_logit_max_abs_diff=low_err,
                    bit_equal=bit_equal)

    base_out, base_ms = propagate(sam_base)
    alone = [propagate(sam_base, [o])[0] for o in range(len(boxes0))]
    per_object = [tuple(np.concatenate([alone[o][t][i] for o in range(len(boxes0))]) for i in (0, 1))
                  for t in range(len(base_out))]
    swapped = [(low[::-1], high[::-1]) for low, high in sam_out]
    sam_check = dict(frames=len(sam_out), objects=len(boxes0), shards=mesh.shape["data"],
                     objects_per_shard=len(boxes0) // mesh.shape["data"], iou_floor=MESH_SAM2_IOU_MIN,
                     vs_unsharded_per_object=agreement(sam_out, per_object),
                     shards_swapped_vs_unsharded_per_object=agreement(swapped, per_object),
                     vs_unsharded_both_objects=agreement(sam_out, base_out),
                     shards_swapped_vs_unsharded_both_objects=agreement(swapped, base_out),
                     logit_atol=MESH_SAM2_LOGIT_ATOL,
                     unsharded_per_object_vs_both_objects=agreement(per_object, base_out),
                     ms_per_frame={"sharded": float(np.median(sam_ms[1:])), "unsharded": float(np.median(base_ms[1:]))})
    del sam_sharded, sam_base, sam_out, base_out, alone, per_object, swapped

    # (e) against the unsharded batched path.
    batched_rows, batched_inliers = smooth_track(refiner, mesh_s, staged, k_s, poses_s, interval=12, cap=512,
                                                 batched_intervals=True)
    smooth_check = dict(frames=staged.n, pose_max_abs_err=float(np.abs(smooth_rows - batched_rows).max()),
                        atol=BATCHED_POSE_ATOL,
                        inliers_max_abs_diff=int(np.abs(np.asarray(smooth_inliers) - batched_inliers).max()),
                        best_frame_equal=int(np.argmax(smooth_inliers)) == int(np.argmax(batched_inliers)))

    # (f) against the unsharded CLIs' outputs of the earlier phases.
    shard_rows = read_results_csv(WORK_DIR / "mesh_shard.csv", t_scale=1.0)
    serial_rows = read_results_csv(WORK_DIR / "serial.csv", t_scale=1.0)
    shard_props = json.loads((WORK_DIR / "mesh_proposals.json").read_text())
    plain_props = json.loads((WORK_DIR / "proposals.json").read_text())

    def prop_key(p):
        return (p["track_id"], p["image_id"], p["mesh"], list(p["bbox"]), p["segmentation"])

    cli_check = dict(
        refine=dict(rows=len(shard_rows), same_rows=[(a.im_id, str(a.obj_id)) for a in shard_rows] ==
                    [(b.im_id, str(b.obj_id)) for b in serial_rows],
                    grid_poses_equal=sum(bool(np.array_equal(a.R, b.R)) for a, b in zip(shard_rows, serial_rows)),
                    t_max_abs_diff=max(float(np.abs(a.t - b.t).max()) for a, b in zip(shard_rows, serial_rows)),
                    score_max_abs_diff=max(abs(a.score - b.score) for a, b in zip(shard_rows, serial_rows)),
                    cli_s=refine_cli_s),
        proposals=dict(count=len(shard_props), equal=[prop_key(p) for p in shard_props] ==
                       [prop_key(p) for p in plain_props],
                       score_max_abs_diff=max((abs(a["score"] - b["score"]) for a, b in zip(shard_props, plain_props)),
                                              default=0.0), cli_s=video_cli_s))

    cards_check = mesh_over_cards(dev, est, torus, crop, cmask, bbox, prevs[2])

    result = dict(mesh=mesh_info, launches=launches, path_s=path_s, setup_s=setup_s, topk=topk,
                  refine=refine_checks, cached=cached_check, sam2=sam_check, smooth=smooth_check, clis=cli_check,
                  real_cards=cards_check, cli_last_lines=cli_out.getvalue().strip().splitlines()[-2:],
                  phase_s=time.perf_counter() - phase_t0, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log("mesh", **result)
    by_dim = launches["K2_by_dim"]
    if min(launches["K1"], launches["K4"], by_dim.get("64", 0), by_dim.get("72", 0), by_dim.get("256", 0)) <= 0:
        raise AssertionError(f"mesh path did not launch K1, K2 at d 64/72/256 and K4: {launches}")
    gate_topk("one card", topk)
    for label, rc in refine_checks.items():
        gate_refine(label, rc)
    c = cached_check
    if not (c["pose_max_abs_err"] <= MESH_POSE_ATOL and c["score_max_abs_err"] <= REFINE_SCORE_ATOL
            and c["view_indices_equal"] and c["slot_of_equal"] and c["lru_equal"]):
        raise AssertionError(f"cached composition against the unsharded cache: {c}")
    if not (sam_check["vs_unsharded_per_object"]["iou_min"] >= MESH_SAM2_IOU_MIN
            and sam_check["shards_swapped_vs_unsharded_per_object"]["iou_min"] < MESH_SAM2_IOU_MIN
            and sam_check["vs_unsharded_both_objects"]["low_res_logit_max_abs_diff"] <= MESH_SAM2_LOGIT_ATOL
            and sam_check["shards_swapped_vs_unsharded_both_objects"]["low_res_logit_max_abs_diff"]
            > MESH_SAM2_LOGIT_ATOL):
        raise AssertionError(f"object-sharded SAM2 against the unsharded predictor: {sam_check}")
    sm = smooth_check
    if not (sm["pose_max_abs_err"] <= BATCHED_POSE_ATOL and sm["inliers_max_abs_diff"] <= 1
            and sm["best_frame_equal"]):
        raise AssertionError(f"sharded smooth pass against the batched path: {sm}")
    rf, pr = cli_check["refine"], cli_check["proposals"]
    if not (rf["same_rows"] and rf["grid_poses_equal"] == rf["rows"] and rf["t_max_abs_diff"] <= MESH_CLI_T_ATOL
            and rf["score_max_abs_diff"] <= REFINE_SCORE_ATOL and pr["equal"] and pr["count"] > 0
            and pr["score_max_abs_diff"] <= REFINE_SCORE_ATOL):
        raise AssertionError(f"CLIs with their shard flags against the unsharded CLIs: {cli_check}")
    gate_cards(cards_check)
    return result, launches


def mesh_over_cards(dev, est, torus, crop, cmask, bbox, prev) -> dict:
    """With two cards or more: (a) and (b) on a mesh over every card ("model"
    axis), and K5 on cuda:1 against its plain version; with one, what was
    skipped."""
    from freepose_tpu_torch.ops.attention import dense_attention_bias, flash_attention_bias
    from freepose_tpu_torch.parallel.mesh import make_mesh

    cards = torch.cuda.device_count()
    out = {"cards": cards}
    if cards < 2:
        out["skipped"] = "one card: the mesh over real cards ((a) and (b) again) and K5 on cuda:1 need two or more"
        return out
    card_mesh = make_mesh(data=1, devices=[torch.device("cuda", i) for i in range(cards)])
    out["mesh"] = dict(shape=card_mesh.shape, devices=[str(d) for d in card_mesh.devices],
                       distinct_devices=len(card_mesh.distinct_devices))
    out["topk"] = mesh_topk(card_mesh, dev)
    if est.n_neighbors % cards == 0:
        out["refine"] = mesh_refine(est, torus, crop, cmask, bbox, prev, card_mesh)
    else:
        out["refine"] = f"skipped: {est.n_neighbors} views do not divide over {cards} cards"
    d1 = torch.device("cuda", 1)
    gen = torch.Generator(device=d1).manual_seed(SEED + 15)
    h, n, d = K5_SHAPE[1:]
    q = torch.randn(K5_SHAPE, generator=gen, device=d1) * QUERY_STD
    kk, vv = (torch.randn(K5_SHAPE, generator=gen, device=d1) for _ in range(2))
    bias = torch.randn((h, n, n), generator=gen, device=d1)
    got = flash_attention_bias(q, kk, vv, d ** -0.5, bias)
    ref = dense_attention_bias(q, kk, vv, d ** -0.5, bias, None)
    torch.cuda.synchronize(d1)
    out["k5_cuda1"] = {"max_abs_err": float((got - ref).abs().max()),
                       "tol_ratio": float(((got - ref).abs() / (K5_TOL["atol"] + K5_TOL["rtol"] * ref.abs())).max())}
    return out


def gate_topk(label: str, tk: dict) -> None:
    if not (tk["indices_identical"] and tk["score_max_abs_err"] <= MESH_TOPK_ATOL
            and not tk["offset_dropped_indices_identical"]):
        raise AssertionError(f"sharded top-k ({label}): {tk}")


def gate_refine(label: str, rc: dict) -> None:
    if not (rc["render_mask_mismatches"] == 0 and rc["score_max_abs_err"] <= REFINE_SCORE_ATOL
            and rc["pose_max_abs_err"] <= MESH_POSE_ATOL and rc["view_index_equal"]
            and (rc["reversed_render_mask_mismatches"] > 0 or rc["reversed_score_max_abs_err"] > REFINE_SCORE_ATOL)
            and min(rc["launches_per_shard"].values()) > 0):
        raise AssertionError(f"refine_sharded on {label}: {rc}")


def gate_cards(out: dict) -> None:
    if out["cards"] < 2:
        return
    gate_topk("cards", out["topk"])
    if isinstance(out["refine"], dict):
        gate_refine("cards", out["refine"])
    if not out["k5_cuda1"]["tol_ratio"] <= 1.0:
        raise AssertionError(f"K5 on cuda:1 against its plain version: {out['k5_cuda1']}")


def phase_mesh_cards(dev) -> dict:
    """The mesh phase's part over real cards alone, without the earlier
    phases' files: the refine cell's estimator (seeded random DINOv2-L
    weights), the torus rendered at the leftovers walk's third pose, the
    walk's second as the previous pose. For a machine with several cards:
    python -c "import torch, chip_smoke as s; s.phase_build();
    s.phase_mesh_cards(torch.device('cuda', 0))"."""
    from freepose_tpu_torch.pipeline.online_pose_estimator import OnlinePoseEstimator
    from freepose_tpu_torch.pipeline.renderer import TemplateRenderer
    from freepose_tpu_torch.pipeline.template_bank import TemplateBank
    from freepose_tpu_torch.scripts.common import load_dino_extractor

    extractor = load_dino_extractor(None, device=dev)

    def feature_fn(imgs):
        return extractor(imgs, layer=DINO_LAYER, feature_type="patch")

    renderer = TemplateRenderer(n_poses=N_VIEWS, device=dev)
    est = OnlinePoseEstimator(feature_fn, TemplateBank(feature_fn, renderer, cache_size=1, device=dev), renderer,
                              n_coarse_poses=N_VIEWS, n_fine_poses=N_FINE, n_neighbors=N_NEIGHBORS,
                              extractor=extractor, feature_layer=DINO_LAYER)
    torus = bumpy_torus()
    walk = leftover_trajectory(est)
    rgb, depth = renderer.render_from_poses(torus, est.fine_poses[walk[2]][None])
    props, masks, boxes = renderer.generate_proposals(rgb, depth)
    out = mesh_over_cards(dev, est, torus, props[0], masks[0], boxes[0].float(), est.fine_poses[walk[1]])
    log("mesh_cards", **out, card=torch.cuda.get_device_name(0))
    gate_cards(out)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    import freepose_tpu_torch  # noqa: F401  (fails outside a checkout of the repository)
    from freepose_tpu_torch.utils import timing

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log("env", python=sys.version.split()[0], torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0))
    with timing.tracing():  # the phases' launch counts (read_launches)
        return run_phases(dev)


def run_phases(dev) -> int:
    phase_build()
    k2 = phase_k2(dev)
    streams = phase_stream_kernels(dev)
    k5, k5_combine = phase_k5(dev)
    mesh = bumpy_torus()
    k1 = phase_k1(dev, mesh)
    _, static = phase_main(dev, mesh)
    torch.cuda.empty_cache()
    try:
        video_result, video = phase_video(dev)
        torch.cuda.empty_cache()
        _, scale = phase_scale(dev)
        torch.cuda.empty_cache()
        _, refine = phase_refine(dev, mesh)
        torch.cuda.empty_cache()
        _, smooth = phase_smooth(dev)
        torch.cuda.empty_cache()
        _, proposals = phase_proposals(dev)
        torch.cuda.empty_cache()
        _, evaluation = phase_eval(dev, mesh)
        torch.cuda.empty_cache()
        _, vos = phase_vos(dev)
        torch.cuda.empty_cache()
        _, texture = phase_texture(dev)
        torch.cuda.empty_cache()
        _, coupled = phase_coupled(dev, mesh)
        torch.cuda.empty_cache()
        _, stride = phase_stride(dev, video_result["sam2_ms_per_frame"])
        torch.cuda.empty_cache()
        _, amg = phase_amg(dev)
        torch.cuda.empty_cache()
        _, leftovers = phase_leftovers(dev, mesh)
        torch.cuda.empty_cache()
        _, mesh_path = phase_mesh(dev, mesh)
    finally:
        shutil.rmtree(WORK_DIR, ignore_errors=True)
    # Launches on each main path's run (`launches_by_path`) and their sum.
    paths = {"static": static, "video": video, "scale": scale, "refine": refine, "smooth": smooth,
             "proposals": proposals, "eval": evaluation, "vos": vos, "texture": texture, "coupled": coupled,
             "stride": stride, "amg": amg, "leftovers": leftovers, "mesh": mesh_path}
    counts = {k1["name"]: lambda p: p["K1"], streams["K3"]["name"]: lambda p: p["K3"],
              streams["K4"]["name"]: lambda p: p["K4"], k5["name"]: lambda p: p["K5"],
              k5_combine["name"]: lambda p: p["K5_combine"],
              streams["combine"]["name"]: lambda p: p["combine"],
              streams["key_tiles"]["name"]: lambda p: p["key_tiles"]}
    for rec, d in ((k2, 64), (streams["K2_d72"], 72), (streams["K2_d256"], 256)):
        counts[rec["name"]] = lambda p, d=d: p["K2_by_dim"].get(str(d), 0)
    records = (k1, k2, streams["K2_d72"], streams["K2_d256"], streams["K3"], streams["K4"], k5, k5_combine,
               streams["combine"],
               streams["key_tiles"])
    for rec in records:
        rec["launches_by_path"] = {path: counts[rec["name"]](p) for path, p in paths.items()}
        rec["launches"] = sum(rec["launches_by_path"].values())
    keys = ("name", "route", "source", "replaces", "launches", "launches_by_path", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: rec[k] for k in keys} for rec in records]}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
