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
             timed; the previous design (the mma.sync tile kernel) checked
             and timed on the same inputs in turns with it (prev_ms); kernel,
             plain and scaled_dot_product_attention times;
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
             attn_mask for K4), the previous design (the tile kernel) checked
             and timed on the same inputs in turns with it (prev_ms), and at
             d 72 its three block sizes and for K4 1-8 key splits checked
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
             (launches_by_kernel["sm90"]); then a torch.profiler breakdown of
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
             VOS_JF_MIN, low-res logits within VIDEO_LOGIT_ATOL; the work
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
    """Set every kernel wrapper's launch count to 0."""
    from freepose_tpu_torch.ops import attention
    from freepose_tpu_torch.ops.rasterizer_cuda import raster_tile

    raster_tile.launches = attention.flash_attention_k3.launches = attention.flash_attention_stream.launches = 0
    attention.flash_attention_k2.launches = attention.flash_attention_bias.launches = 0
    attention.bias_combine.launches = 0
    attention.attention_combine.launches = attention.key_tiles.launches = 0
    attention.flash_attention_k2.launches_by_dim = {}
    for kernel in attention.launches_by_kernel:
        attention.launches_by_kernel[kernel] = 0


def read_launches() -> dict:
    """Every kernel wrapper's launch count, K2 also by head dim, and the
    attention launches by device program (`launches_by_kernel`: "sm90" the
    wgmma + TMA kernel, "tile" the mma.sync tile kernel, "f32" the fp32
    one); "key_tiles" counts K4's list kernel."""
    from freepose_tpu_torch.ops import attention
    from freepose_tpu_torch.ops.rasterizer_cuda import raster_tile

    return {"K1": raster_tile.launches, "K2": attention.flash_attention_k2.launches,
            "K3": attention.flash_attention_k3.launches, "K4": attention.flash_attention_stream.launches,
            "K5": attention.flash_attention_bias.launches, "K5_combine": attention.bias_combine.launches,
            "combine": attention.attention_combine.launches,
            "key_tiles": attention.key_tiles.launches,
            "K2_by_dim": {str(d): n for d, n in sorted(attention.flash_attention_k2.launches_by_dim.items())},
            "launches_by_kernel": dict(attention.launches_by_kernel)}


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


def bumpy_torus(seed: int = SEED, n_u: int = 128, n_v: int = 64):
    """Seeded coloured torus at exactly the renderer's budget: 8192
    vertices, 16384 faces, minor radius modulated by random harmonics."""
    from freepose_tpu_torch.io.mesh import TriMesh

    rng = np.random.default_rng(seed)
    u = 2 * np.pi * np.arange(n_u) / n_u
    v = 2 * np.pi * np.arange(n_v) / n_v
    uu, vv = np.meshgrid(u, v, indexing="ij")
    bump = sum(rng.uniform(0.03, 0.08) * np.sin(a * uu + b * vv + rng.uniform(0, 2 * np.pi))
               for a, b in rng.integers(1, 6, size=(4, 2)))
    r = 0.35 * (1.0 + bump)
    verts = np.stack([(1.0 + r * np.cos(vv)) * np.cos(uu), (1.0 + r * np.cos(vv)) * np.sin(uu),
                      0.6 * r * np.sin(vv)], -1).reshape(-1, 3)
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
                                                  flash_attention_tile, sm90_config, sm90_key_tile)
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
        c["prev"] = check_attention(flash_attention_tile(q, k, v, scale), ref, allowed, {})
        del wrong, out
        if label != "ragged":
            # Each d 64 build of the kernel at this shape: held to the same
            # bound, and its device time beside the tile kernel's and SDPA's.
            c["configs"] = {}
            for config in SM90_D64_CONFIGS:
                def run(config=config):
                    return flash_attention_sm90(q, k, v, scale, config)

                c["configs"][f"{config[0]}wg"] = {"tol_ratio": check_attention(run(), ref, allowed, {})["tol_ratio"],
                                                  "device_ms": device_ms(run)}
            c["device"] = {"ms": c["configs"][f"{picked[0]}wg"]["device_ms"],
                           "prev_ms": device_ms(lambda: flash_attention_tile(q, k, v, scale)),
                           "sdpa_ms": device_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))}
            if label != "bank":  # the bank shape is timed below, for the kernels line
                c["ms"], c["prev_ms"] = in_turns(lambda: flash_attention(q, k, v, scale),
                                                 lambda: flash_attention_tile(q, k, v, scale), 10)
                # Where CUDA events exceed the device times, the host's.
                c["host_ms"] = {"ms": host_ms(lambda: flash_attention(q, k, v, scale)),
                                "prev_ms": host_ms(lambda: flash_attention_tile(q, k, v, scale)),
                                "sdpa_ms": host_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))}
        if label == "bank":
            main = (q, k, v)
        del ref, allowed
    q, k, v = main
    ms, prev_ms = in_turns(lambda: flash_attention(q, k, v, scale), lambda: flash_attention_tile(q, k, v, scale), 10)
    plain_ms = cuda_ms(lambda: dense_attention(q, k, v, scale), reps=3)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), reps=10)
    bh = BANK_BATCH * heads
    flops = 4 * bh * n * n * d
    bound_ms, bound_by = bound(flops, 4 * bh * n * d * q.element_size())
    rec = dict(name="K2 flash_attention_k2 (whole-K/V attention), d 64", route="cuda", source=SM90_SOURCE,
               replaces="freepose_tpu/ops/attention.py:75", max_abs_err=checks["bank"]["max_abs_err"],
               ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    log("k2", shape=[BANK_BATCH, heads, n, d], dtype="bf16", checks=checks, tol=ATTN_TOL, tol_fp32=K2_TOL_FP32,
        ms=ms, prev_ms=prev_ms, plain_ms=plain_ms, sdpa_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
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
    version and timed beside it, beside the previous design (the tile
    kernel, on the same inputs) and beside SDPA, with the warpgroup and
    split configurations the rules choose from; each on a ragged key count
    against a kernel that reads the next head's rows; K3's combine and K4's
    list kernel against their plain versions. Returns {kernel: record}."""
    import torch.nn.functional as F

    from freepose_tpu_torch.ops.attention import (bf16_error_bound, dense_attention, dense_attention_masked,
                                                  flash_attention_k2, flash_attention_k3, flash_attention_sm90,
                                                  flash_attention_stream, flash_attention_tile, sm90_config,
                                                  sm90_key_tile)

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
        "K2_d72": dict(q=(1, 8, hw, 72), nk=hw, kernel=flash_attention_k2, mask=None, configs=SM90_D72_CONFIGS,
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

            def prev():
                return flash_attention_tile(q, k, v, scale)

            def plain():
                return dense_attention(q, k, v, scale)

            def library():
                return F.scaled_dot_product_attention(q, k, v, scale=scale)
        else:
            def run():
                return c["kernel"](q, k, v, scale, kv_mask=m)

            def prev():
                return flash_attention_tile(q, k, v, scale, kv_mask=m)

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
        check["prev"] = check_attention(prev(), ref, allowed, {})  # the previous design, on the same inputs
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
        ms, extra["prev_ms"] = in_turns(run, prev, 10)
        extra["device"] = {"ms": device_ms(run), "prev_ms": device_ms(prev), "sdpa_ms": device_ms(library)}
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
    from freepose_tpu_torch.ops.attention import dense_attention, flash_attention_fn, flash_attention_k2
    from freepose_tpu_torch.ops.rasterizer_cuda import raster_tile
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
    pack_launches = {"K1": raster_tile.launches, "K2": flash_attention_k2.launches}
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
    gen = predictor.propagate_in_video(prompted(), binarize=True)
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
    # K4 in each memory-attention layer. Hiera-L: 3; 4 layers.
    hiera, layers = predictor.config.sam.hiera, predictor.config.mem.num_layers
    n_global = sum(1 for i in hiera.global_attention_blocks if i < sum(hiera.blocks_per_stage))
    expected = [{"K2": n_global, "K4": 0}] + [{"K2": n_global + layers, "K4": layers}] * (VIDEO_FRAMES - 1)
    if per_frame != expected:
        raise AssertionError(f"kernel launches per frame {per_frame}, expected {expected}")
    ret_ms, n_scored = [], 0
    for t in range(VIDEO_FRAMES):
        t0 = time.perf_counter()
        n_scored += len(cli.retrieve_frame(extractor, bank_dev, frames[t], masks_k[t], DINO_LAYER, MIN_MASK_PX))
        torch.cuda.synchronize()
        ret_ms.append((time.perf_counter() - t0) * 1e3)

    gen = predictor.propagate_in_video(prompted(), binarize=True)
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
    if launches["launches_by_kernel"]["tile"] != 0:
        raise AssertionError(f"video path ran the previous design's tile kernel: {launches}")
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
    from freepose_tpu_torch.ops import rasterizer_cuda
    from freepose_tpu_torch.ops.attention import dense_attention, flash_attention_fn
    from freepose_tpu_torch.ops.rasterizer_cuda import prologue, raster_tile, raster_tile_plain
    from freepose_tpu_torch.pipeline import fine_cache
    from freepose_tpu_torch.pipeline.fine_cache import cached_refine_auto_step, init_device_cache
    from freepose_tpu_torch.pipeline.online_pose_estimator import (AutoRefineChain, OnlinePoseEstimator,
                                                                   render_view_block, rescore_views,
                                                                   select_neighborhood)
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
                                      extractor.config.dtype, dev)
            cached_refine_auto_step(
                state, est.fine_poses, prev, prev, *est._padded_mesh(mid, meshes[mid]), renderer.k, crop, cmask, k,
                est._f32(bbox), est._f32(scale), extractor=extractor, layer=DINO_LAYER, settings=renderer.settings,
                pose_chunk=renderer.pose_chunk, resolution=RES, mask_scores=False,
                rendering_scale=est.rendering_scale, neighborhood_deg=NEIGHBORHOOD, n_neighbors=N_NEIGHBORS,
                miss_bucket=N_NEIGHBORS)
            qf = normalize_feats(feature_fn(crop[None])[0])
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
    mask_mismatch = int((runs[False]["state"].masks[runs[False]["slots"]] !=
                         runs[True]["state"].masks[runs[True]["slots"]]).sum())
    score_err = float((kernel_scores - plain_scores)[valid].abs().max())
    off_by_one = float((scores_of(runs[False], shift=1) - plain_scores)[valid].abs().max())
    frame1_launches = {"kernels": runs[False]["launches"], "plain": runs[True]["launches"]}
    del runs, state

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
            gen = predictor.propagate_in_video(state)
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
                  k2_launches_by_dim=k2, k4_launches=launches["K4"], launches=launches,
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    import freepose_tpu_torch  # noqa: F401  (fails outside a checkout of the repository)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log("env", python=sys.version.split()[0], torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0))

    phase_build()
    k2 = phase_k2(dev)
    streams = phase_stream_kernels(dev)
    k5, k5_combine = phase_k5(dev)
    mesh = bumpy_torus()
    k1 = phase_k1(dev, mesh)
    _, static = phase_main(dev, mesh)
    torch.cuda.empty_cache()
    try:
        _, video = phase_video(dev)
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
    finally:
        shutil.rmtree(WORK_DIR, ignore_errors=True)
    # Launches on each main path's run (`launches_by_path`) and their sum.
    paths = {"static": static, "video": video, "scale": scale, "refine": refine, "smooth": smooth,
             "proposals": proposals, "eval": evaluation, "vos": vos}
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
