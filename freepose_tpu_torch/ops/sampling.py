"""Resampling ops: area/bilinear/bicubic resize, ROI-align, masked FFA pooling.

Counterpart of freepose_tpu.ops.sampling, in plain PyTorch (none of these
is a Pallas kernel in the JAX package). Resizes work on the last two axes of
[..., H, W]. The linear and bicubic resizes are separable products with
small interpolation matrices, as in the JAX package, so they round alike;
`resize_bilinear` matches torch's F.interpolate(mode="bilinear",
align_corners=False) and `resize_bicubic_torch` its bicubic mode.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from freepose_tpu_torch.utils import timing


def hat_taps(pos: torch.Tensor, size: int, border: bool = False):
    """The two source indices along one axis of each position [...] and
    their bilinear hat weights max(0, 1 - |i - pos|): [(i0, w0), (i0 + 1,
    w1)]. border=True clamps the position to the axis (grid_sample
    padding_mode="border"); otherwise an index off the axis gets weight 0
    (padding_mode="zeros"). The weighted sum over both axes' taps is the
    JAX package's hat-weight matrix product, read by index."""
    if border:
        pos = pos.clamp(0.0, size - 1.0)
    i0 = torch.floor(pos)
    taps = []
    for idx, wt in ((i0, 1.0 - (pos - i0)), (i0 + 1.0, 1.0 - (i0 + 1.0 - pos))):
        inside = (idx >= 0) & (idx < size)
        taps.append((idx.clamp(0, size - 1).long(), torch.where(inside, wt, 0.0)))
    return taps


def resize_area(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Area-averaging resize of [..., H, W] to fp32 (cv2.INTER_AREA for
    downsampling). Integer factors take the exact box mean; other sizes an
    antialiased linear resize, as jax.image.resize(linear, antialias) does."""
    h, w = img.shape[-2], img.shape[-1]
    oh, ow = out_hw
    img = img.to(torch.float32)
    if h % oh == 0 and w % ow == 0:
        r = img.reshape(img.shape[:-2] + (oh, h // oh, ow, w // ow))
        return r.mean(dim=(-3, -1))
    lead = img.shape[:-2]
    flat = img.reshape(-1, 1, h, w)
    out = F.interpolate(flat, size=(oh, ow), mode="bilinear", align_corners=False, antialias=True)
    return out.reshape(lead + (oh, ow))


def _linear_resize_matrix(n_in: int, n_out: int, align_corners: bool, device) -> torch.Tensor:
    """[n_out, n_in] 1-D linear interpolation matrix (2 non-zeros a row)."""
    dst = torch.arange(n_out, dtype=torch.float32, device=device)
    if align_corners:
        s = dst * ((n_in - 1) / max(n_out - 1, 1))
    else:
        s = (dst + 0.5) * (n_in / n_out) - 0.5  # torch bilinear source coordinate
    i0 = torch.clamp(torch.floor(s), 0, n_in - 1)
    i1 = torch.clamp(i0 + 1, 0, n_in - 1)
    wgt = torch.clamp(s - i0, 0.0, 1.0)
    cols = torch.arange(n_in, device=device)[None, :]
    m = (cols == i0.long()[:, None]) * (1.0 - wgt)[:, None]
    return m + (cols == i1.long()[:, None]) * wgt[:, None]


def _resize_linear_mm(img: torch.Tensor, out_hw: tuple[int, int], align_corners: bool) -> torch.Tensor:
    h, w = img.shape[-2], img.shape[-1]
    oh, ow = out_hw
    out = img.to(torch.float32)
    if oh != h:
        out = torch.matmul(_linear_resize_matrix(h, oh, align_corners, img.device), out)
    if ow != w:
        out = torch.matmul(out, _linear_resize_matrix(w, ow, align_corners, img.device).T)
    return out


def resize_bilinear(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of [..., H, W] to fp32, as torch F.interpolate
    (align_corners=False, no antialias)."""
    return _resize_linear_mm(img, out_hw, align_corners=False)


def resize_bilinear_ac(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of [..., H, W] to fp32 with align_corners=True."""
    return _resize_linear_mm(img, out_hw, align_corners=True)


def ffa_pool(patch_feats: torch.Tensor, masks: torch.Tensor, grid: int = 30) -> torch.Tensor:
    """Foreground-feature averaging: the masked mean of patch tokens,
    L2-normalised. patch_feats [N, grid², D]; masks [N, H, W] bool. Masks are
    area-downsampled to the patch grid and thresholded > 0; a mask that
    vanishes on the grid takes the unmasked mean instead of NaN."""
    n = patch_feats.shape[0]
    m = resize_area(masks.to(torch.float32), (grid, grid)) > 0
    m = m.reshape(n, grid * grid, 1).to(patch_feats.dtype)
    cnt = m.sum(dim=1)
    mean_masked = (patch_feats * m).sum(dim=1) / torch.clamp(cnt, min=1.0)
    mean_all = patch_feats.mean(dim=1)
    feats = torch.where(cnt > 0, mean_masked, mean_all)
    return feats / torch.clamp(torch.linalg.norm(feats, dim=-1, keepdim=True), min=1e-12)


def roi_align(image: torch.Tensor, boxes: torch.Tensor, out_h: int, out_w: int,
              sampling_ratio: int = 2) -> torch.Tensor:
    """torchvision-style ROI align (aligned=False): image [C, H, W], boxes
    [N, 4] xyxy -> [N, C, out_h, out_w]. The s x s bilinear taps of an
    axis-aligned box factor into one weight matrix per axis, as in the JAX
    package."""
    c, h, w = image.shape
    s = sampling_ratio
    boxes = boxes.to(torch.float32)
    dev = image.device

    def axis_weights(lo, size, n_out, n_src):  # lo, size [N] -> [N, n_out, n_src]
        i = torch.arange(n_out, dtype=torch.float32, device=dev)
        t = torch.arange(s, dtype=torch.float32, device=dev)
        coords = lo[:, None, None] + (i[None, :, None] + (t[None, None, :] + 0.5) / s) * (size / n_out)[:, None, None]
        valid = (coords > -1.0) & (coords < n_src)  # torchvision's zero padding
        cc = torch.clamp(coords, 0.0, n_src - 1)
        src = torch.arange(n_src, dtype=torch.float32, device=dev)
        tri = torch.clamp(1.0 - torch.abs(src - cc[..., None]), min=0.0)
        return (tri * valid[..., None]).mean(dim=2)

    x1, y1, x2, y2 = boxes.unbind(-1)
    wy = axis_weights(y1, torch.clamp(y2 - y1, min=1e-6), out_h, h)  # [N, oh, H]
    wx = axis_weights(x1, torch.clamp(x2 - x1, min=1e-6), out_w, w)  # [N, ow, W]
    return torch.einsum("noi,cij,npj->ncop", wy, image.to(torch.float32), wx)


def _bicubic_axis_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] matrix of torch's 4-tap bicubic weights (a = -0.75,
    align_corners=False, clamped taps)."""
    scale = in_size / out_size
    src = (np.arange(out_size, dtype=np.float32) + 0.5) * scale - 0.5
    base = np.floor(src).astype(np.int32)
    frac = src - base
    taps = np.arange(-1, 3)
    idx = np.clip(base[:, None] + taps[None, :], 0, in_size - 1)
    t = np.abs(frac[:, None] - taps[None, :].astype(np.float32))
    a = -0.75
    wts = np.where(t <= 1.0, (a + 2.0) * t**3 - (a + 3.0) * t**2 + 1.0,
                   np.where(t < 2.0, a * t**3 - 5.0 * a * t**2 + 8.0 * a * t - 4.0 * a, 0.0)).astype(np.float32)
    mat = np.zeros((out_size, in_size), np.float32)
    np.add.at(mat, (np.repeat(np.arange(out_size), 4), idx.reshape(-1)), wts.reshape(-1))
    return mat


@functools.lru_cache(maxsize=64)
def _bicubic_axis_weights(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """`_bicubic_axis_matrix` on `device`, uploaded once per shape and
    device: a CUDA graph cannot capture an upload from pageable memory, and
    the Hiera trunk replays as one (models/sam2/predictor.py:_TrunkGraph).
    Made outside inference mode, so a later call that records autograd can
    use it; callers only read it."""
    with torch.inference_mode(False), timing.wait("sampling.resize_bicubic"):  # the upload synchronises
        return torch.as_tensor(_bicubic_axis_matrix(in_size, out_size), device=device)


def resize_bicubic_torch(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bicubic resize of [..., H, W] to fp32, as torch F.interpolate
    (mode="bicubic", align_corners=False, antialias=False); the Hiera
    windowed position embedding's resample."""
    h, w = img.shape[-2], img.shape[-1]
    wy = _bicubic_axis_weights(h, out_hw[0], img.device)
    wx = _bicubic_axis_weights(w, out_hw[1], img.device)
    return torch.matmul(torch.matmul(wy, img.to(torch.float32)), wx.T)
