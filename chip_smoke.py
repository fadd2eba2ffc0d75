"""Smoke run of the PyTorch/CUDA port (freepose_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each on stdout:
  1. build   both hand-written kernels (csrc/raster_tile.cu, csrc/flash_attention.cu)
             with nvcc, one process per source, started together;
  2. k2      the attention kernel against its plain PyTorch version at the
             DINOv2-L shapes of the main path (bank batch 128, a frame of 4
             proposals, and batch 8; H 16, n 905, d 64, bf16), a ragged
             length and fp32;
             kernel, plain and scaled_dot_product_attention times;
  3. k1      the raster tile kernel against its plain version on a seeded
             16k-face coloured mesh, one 128-pose chunk at 420², tile 28,
             M 256: hit-mask mismatches, depth/rgb error, prologue, kernel and
             plain times;
  4. main    the coarse-pose path at full width: DINOv2-L/14-reg truncated at
             layer 22, bf16, seeded random weights in the JAX package's layout
             carried over by dinov2_from_jax; TemplateBank.build_pack of the
             mesh (600 views through the raster kernel, 600 crops through the
             ViT in batches of 128, depth_stats); estimate_batch on 4
             proposals cut from a rendered frame. Launch counts are zeroed
             before the pack build, read after the frame, and must be > 0
             for both kernels; then a torch.profiler breakdown of one ViT
             batch and one frame;
then the kernels JSON line, the card's name and power limit, and last the
device JSON line. Exits non-zero, printing no result, without a GPU or
without the rest of the repository beside it.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12

# Tolerances. K2 against its plain version: bf16 outputs of O(1) size, the
# online softmax rescales p in another order than the one-pass plain version
# before p is rounded to bf16. K1 against its plain version: the same fp32
# operations in the same order (kernel built without FMA contraction).
K2_TOL = dict(atol=2e-2, rtol=2e-2)
K2_TOL_FP32 = dict(atol=1e-5, rtol=1e-5)
K1_ATOL = 1e-5

SEED = 0
RES, TILE, MFACES, CHUNK = 420, 28, 256, 128
N_VIEWS, BANK_BATCH, N_PROPOSALS = 600, 128, 4
DINO_LAYER = 22


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
    logs = cuda_build.build(["raster_tile", "flash_attention"])
    secs = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in out.splitlines() if "registers" in ln] for name, out in logs.items()}
    log("build", seconds=secs, ptxas=ptxas)


def phase_k2(dev) -> dict:
    import torch.nn.functional as F

    from freepose_tpu_torch.ops.attention import dense_attention, flash_attention

    gen = torch.Generator(device=dev).manual_seed(SEED)
    scale = 64 ** -0.5
    heads, n, d = 16, 1 + 4 + (RES // 14) ** 2, 64

    def qkv(b, length, dtype):
        return [torch.randn((b, heads, length, d), generator=gen, device=dev).to(dtype) for _ in range(3)]

    checks = {}
    for label, b, length, dtype, tol in (("bank", BANK_BATCH, n, torch.bfloat16, K2_TOL),
                                         ("frame", N_PROPOSALS, n, torch.bfloat16, K2_TOL),
                                         ("b8", 8, n, torch.bfloat16, K2_TOL),
                                         ("ragged", 8, 37, torch.bfloat16, K2_TOL),
                                         ("fp32", 2, 130, torch.float32, K2_TOL_FP32)):
        q, k, v = qkv(b, length, dtype)
        out = flash_attention(q, k, v, scale)
        ref = dense_attention(q, k, v, scale)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(), **tol)
        checks[label] = float((out.float() - ref.float()).abs().max())
        if label == "bank":
            main = (q, k, v)
    q, k, v = main
    ms = cuda_ms(lambda: flash_attention(q, k, v, scale), reps=10)
    plain_ms = cuda_ms(lambda: dense_attention(q, k, v, scale), reps=3)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), reps=10)
    bh = BANK_BATCH * heads
    nbytes = 4 * bh * n * d * q.element_size()
    flops = 4 * bh * n * n * d
    bytes_ms, ops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    rec = dict(name="K2 flash_attention (whole-K/V attention)", route="cuda",
               source="freepose_tpu_torch/csrc/flash_attention.cu",
               replaces="freepose_tpu/ops/attention.py:75", max_abs_err=checks["bank"],
               ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations", library_ms=library_ms)
    log("k2", shape=[BANK_BATCH, heads, n, d], dtype="bf16", max_abs_err=checks, tol=K2_TOL,
        ms=ms, plain_ms=plain_ms, sdpa_ms=library_ms, bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
        tflops=flops / ms / 1e9)
    return rec


def phase_k1(dev, mesh) -> dict:
    from freepose_tpu_torch.io.mesh import pad_mesh
    from freepose_tpu_torch.ops.rasterizer import RasterSettings
    from freepose_tpu_torch.ops.rasterizer_cuda import N_ATTRS, _bin_and_pack, _ROWS, raster_tile, raster_tile_plain
    from freepose_tpu_torch.pipeline.renderer import RENDERING_SCALE, TemplateRenderer

    renderer = TemplateRenderer(n_poses=N_VIEWS, resolution=RES, device=dev)
    settings = RasterSettings(resolution=RES, tile=TILE, max_faces_per_tile=MFACES)
    padded = pad_mesh(mesh, renderer.max_vertices, renderer.max_faces)
    v, c, f, valid = (torch.as_tensor(a, device=dev) for a in padded)
    v = v * RENDERING_SCALE
    poses = renderer.poses[:CHUNK]
    ks = renderer.k.expand(poses.shape[0], 3, 3)

    def prologue():
        return _bin_and_pack(v, c, f, valid, poses, ks, settings)

    prologue_ms = cuda_ms(prologue, reps=3)
    attrs, origins = prologue()
    out = raster_tile(attrs, origins, TILE, settings.ambient, False)
    ref = raster_tile_plain(attrs, origins, TILE, settings.ambient, False)
    torch.cuda.synchronize()
    mismatch = int(((out[..., 0] > 0) != (ref[..., 0] > 0)).sum())
    depth_err = float((out[..., 0] - ref[..., 0]).abs().max())
    rgb_err = float((out[..., 1:] - ref[..., 1:]).abs().max())
    dout = raster_tile(attrs, origins, TILE, settings.ambient, True)
    dref = raster_tile_plain(attrs, origins, TILE, settings.ambient, True)
    depth_only_err = float((dout - dref).abs().max())
    hit_px = int((out[..., 0] > 0).sum())
    if mismatch or max(depth_err, rgb_err, depth_only_err) > K1_ATOL or hit_px == 0:
        raise AssertionError(f"K1 disagrees with its plain version: {mismatch} hit-mask mismatches, "
                             f"depth {depth_err}, rgb {rgb_err}, depth_only {depth_only_err}, hits {hit_px}")
    ms = cuda_ms(lambda: raster_tile(attrs, origins, TILE, settings.ambient, False), reps=10)
    plain_ms = cuda_ms(lambda: raster_tile_plain(attrs, origins, TILE, settings.ambient, False), reps=1)
    pt, _, m = attrs.shape
    tp = TILE * TILE
    rows_used = _ROWS["c2b"] + 1  # geometry + colour rows; the rest of N_ATTRS is padding
    nbytes = pt * (rows_used * m * 4 + 2 * 4 + tp * 4 * 4)
    valid_pairs = int((attrs[:, _ROWS["valid"]] > 0.5).sum()) * tp
    # Every valid (pixel, face) pair needs its coverage test: three edge
    # functions (5 ops each), three sign products and three compares.
    flops = 21 * valid_pairs
    bytes_ms, ops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    rec = dict(name="K1 raster_tile (tile rasterizer)", route="cuda",
               source="freepose_tpu_torch/csrc/raster_tile.cu",
               replaces="freepose_tpu/ops/rasterizer_pallas.py:44", max_abs_err=max(depth_err, rgb_err),
               ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations", library_ms=None)
    log("k1", poses=poses.shape[0], tiles=pt, faces_per_tile=m, attrs_rows=N_ATTRS, hit_px=hit_px,
        hit_mask_mismatches=mismatch, depth_max_err=depth_err, rgb_max_err=rgb_err,
        depth_only_max_err=depth_only_err, atol=K1_ATOL, prologue_ms=prologue_ms, ms=ms,
        plain_ms=plain_ms, bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
        valid_pairs=valid_pairs)
    del attrs, origins, out, ref, dout, dref
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
    return {label: {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
                    "top": [[name[:60], ms, count] for name, ms, count in kernels[:top]]}}


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
    from freepose_tpu_torch.ops.attention import dense_attention, flash_attention
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
    raster_tile.launches = flash_attention.launches = 0
    t0 = time.perf_counter()
    pack = bank.build_pack("smoke_torus", mesh)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    pack_launches = {"K1": raster_tile.launches, "K2": flash_attention.launches}
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
    launches = {"K1": raster_tile.launches, "K2": flash_attention.launches}

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
        blk.attn.attention_fn = flash_attention
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
    if min(launches.values()) <= 0:
        raise AssertionError(f"main path did not launch every kernel: {launches}")
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
    mesh = bumpy_torus()
    k1 = phase_k1(dev, mesh)
    _, launches = phase_main(dev, mesh)
    k1["launches"], k2["launches"] = launches["K1"], launches["K2"]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: rec[k] for k in keys} for rec in (k1, k2)]}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
