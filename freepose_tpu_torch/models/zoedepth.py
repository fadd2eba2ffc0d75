"""ZoeDepth metric monocular depth (BEiT trunk + DPT neck + metric-bins head).

Counterpart of freepose_tpu.models.zoedepth, as nn.Modules: the BEiT-L/16
trunk (models/beit.py) tapped at 4 depths, the DPT reassemble stage and
fusion pyramid, the relative-depth head, then the metric-bins head (seed bin
regressor, 4 attractor refinements, a conditional log-binomial softmax over
bin centres; depth = Σ p·c). The neck and head run NCHW, torch's layout;
the JAX model runs NHWC, which changes no number. Kept from the JAX model:
the attractors' fixed strengths (alpha 300, gamma 2), softplus bin centres,
the log-binomial constant evaluated on the host in float64, and which
interpolations align corners. Names follow the JAX tree
(models/convert.py:zoedepth_from_jax).

The production depth model is fp32 (`DepthConfig.dtype`). On the card
`MetricDepthEstimator` turns on `use_flash`, so the 24 BEiT blocks run their
biased attention on kernel K5; on the CPU they run the plain version.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from freepose_tpu_torch.device import resolve_device
from freepose_tpu_torch.models.beit import BEIT_TEST, BeitBackbone, BeitConfig
from freepose_tpu_torch.models.layers import Dense
from freepose_tpu_torch.ops.sampling import resize_bilinear, resize_bilinear_ac


@dataclasses.dataclass(frozen=True)
class DepthConfig:
    beit: BeitConfig = BeitConfig()
    neck_hidden_sizes: tuple = (256, 512, 1024, 1024)
    reassemble_factors: tuple = (4, 2, 1, 0.5)
    fusion_hidden_size: int = 256
    bottleneck_features: int = 256
    num_relative_features: int = 32
    bin_embedding_dim: int = 128
    num_attractors: tuple = (16, 8, 4, 1)
    n_bins: int = 64
    min_depth: float = 1e-3
    max_depth: float = 10.0
    min_temp: float = 0.0212
    max_temp: float = 50.0
    bin_centers_type: str = "softplus"  # or "normed"
    attractor_kind: str = "mean"
    dtype: torch.dtype = torch.float32

    @property
    def image_size(self) -> int:
        return self.beit.image_size


DEPTH_TEST = DepthConfig(
    beit=BEIT_TEST,
    neck_hidden_sizes=(16, 24, 32, 40), fusion_hidden_size=32,
    bottleneck_features=32, num_relative_features=8, bin_embedding_dim=8,
    num_attractors=(4, 4, 4, 4), n_bins=64,
)


class Conv3x3(nn.Conv2d):
    """A 3x3 convolution at stride 1 with "SAME" padding, computed as one
    matrix product over im2col columns. In fp32 with TF32 off, as this model
    runs, cuDNN takes some of ZoeD_N's shapes as tens of thousands of gemv
    launches: rel_conv1 ([1, 256, 192, 192] -> 128 channels) ran 33,024 of
    them, 97.9 of the forward's 160.4 device ms (chip_smoke.py's scale-phase
    profile on an H100)."""

    def __init__(self, n_in: int, n_out: int, dtype: torch.dtype, bias: bool = True):
        super().__init__(n_in, n_out, 3, padding=1, bias=bias, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        cols = F.unfold(x.to(self.weight.dtype), 3, padding=1)  # [B, C·9, H·W], (c, kh, kw) order
        out = torch.matmul(self.weight.reshape(self.out_channels, -1), cols)
        if self.bias is not None:
            out = out + self.bias[:, None]
        return out.reshape(b, self.out_channels, h, w)


def _conv(n_in: int, n_out: int, kernel: int, dtype: torch.dtype, bias: bool = True) -> nn.Conv2d:
    """flax.linen.Conv with "SAME" padding at stride 1."""
    if kernel == 3:
        return Conv3x3(n_in, n_out, dtype, bias=bias)
    return nn.Conv2d(n_in, n_out, kernel, padding=kernel // 2, bias=bias, dtype=dtype)


def _resize(x: torch.Tensor, hw, align_corners: bool) -> torch.Tensor:
    hw = tuple(hw)
    return resize_bilinear_ac(x, hw) if align_corners else resize_bilinear(x, hw)


class ReassembleStage(nn.Module):
    """Tokens (with cls) -> 4 image-like maps at pyramid scales (HF
    ZoeDepthReassembleStage). The upsampling ConvTranspose (kernel = stride)
    keeps torch's (in, out, k, k) weight in the JAX tree as resize{i}_w."""

    def __init__(self, config: DepthConfig):
        super().__init__()
        c = self.config = config
        d = c.beit.hidden_size
        for i, (ch, factor) in enumerate(zip(c.neck_hidden_sizes, c.reassemble_factors)):
            setattr(self, f"readout{i}", Dense(2 * d, d, dtype=c.dtype))
            setattr(self, f"proj{i}", _conv(d, ch, 1, c.dtype))
            if factor > 1:
                k = int(factor)
                setattr(self, f"resize{i}_w", nn.Parameter(torch.zeros(ch, ch, k, k)))
                setattr(self, f"resize{i}_b", nn.Parameter(torch.zeros(ch)))
            elif factor < 1:
                setattr(self, f"resize{i}", nn.Conv2d(ch, ch, 3, stride=2, padding=1, dtype=c.dtype))

    def forward(self, taps, window) -> list[torch.Tensor]:
        c = self.config
        gh, gw = window
        out = []
        for i, (tokens, factor) in enumerate(zip(taps, c.reassemble_factors)):
            patch = tokens[:, 1:]
            readout = tokens[:, :1].expand_as(patch)
            h = F.gelu(getattr(self, f"readout{i}")(torch.cat([patch, readout], dim=-1)))
            h = h.reshape(h.shape[0], gh, gw, -1).permute(0, 3, 1, 2)
            h = getattr(self, f"proj{i}")(h)
            if factor > 1:
                w = getattr(self, f"resize{i}_w")
                h = F.conv_transpose2d(h, w.to(h.dtype), getattr(self, f"resize{i}_b").to(h.dtype),
                                       stride=int(factor))
            elif factor < 1:
                h = getattr(self, f"resize{i}")(h)
            out.append(h)
        return out


class PreActResidual(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.conv1 = _conv(dim, dim, 3, dtype)
        self.conv2 = _conv(dim, dim, 3, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FusionLayer(nn.Module):
    """DPT feature fusion: optional skip add through a residual unit (not on
    the deepest layer, which has none), residual unit, 2x upsample
    (align_corners=True), 1x1 projection."""

    def __init__(self, config: DepthConfig, has_residual: bool):
        super().__init__()
        d = config.fusion_hidden_size
        if has_residual:
            self.res1 = PreActResidual(d, config.dtype)
        self.res2 = PreActResidual(d, config.dtype)
        self.proj = _conv(d, d, 1, config.dtype)

    def forward(self, x: torch.Tensor, residual: torch.Tensor | None = None) -> torch.Tensor:
        if residual is not None:
            if residual.shape[-2:] != x.shape[-2:]:
                residual = _resize(residual, x.shape[-2:], align_corners=False)
            x = x + self.res1(residual)
        x = self.res2(x)
        x = _resize(x, (x.shape[-2] * 2, x.shape[-1] * 2), align_corners=True)
        return self.proj(x)


class Projector(nn.Module):
    def __init__(self, n_in: int, out_features: int, dtype: torch.dtype, mlp_dim: int = 128):
        super().__init__()
        self.conv1 = _conv(n_in, mlp_dim, 1, dtype)
        self.conv2 = _conv(mlp_dim, out_features, 1, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(x)))


def _inv_attractor(dx: torch.Tensor) -> torch.Tensor:
    """dc = dx / (1 + 300·dx²): the torch default strengths, which the
    reference implementation uses whatever it is configured with."""
    return dx / (1.0 + 300.0 * dx * dx)


class AttractorLayer(nn.Module):
    """Bin-centre refinement (HF ZoeDepthAttractorLayer[Unnormed]); bins and
    attractors on the channel axis."""

    def __init__(self, config: DepthConfig, n_attractors: int):
        super().__init__()
        c = self.config = config
        self.n_attractors = n_attractors
        normed = c.bin_centers_type == "normed"
        self.conv1 = _conv(c.bin_embedding_dim, c.bin_embedding_dim, 1, c.dtype)
        self.conv2 = _conv(c.bin_embedding_dim, 2 * n_attractors if normed else n_attractors, 1, c.dtype)

    def forward(self, x, prev_bin, prev_bin_embedding):
        c = self.config
        if prev_bin_embedding is not None:
            x = x + _resize(prev_bin_embedding, x.shape[-2:], align_corners=True)
        h = self.conv2(F.relu(self.conv1(x)))
        centers = _resize(prev_bin, x.shape[-2:], align_corners=True)
        normed = c.bin_centers_type == "normed"
        if normed:
            # Upstream bug kept for weight parity: of the 2-per-attractor
            # channels only the first is used (modeling_zoedepth.py:643-647).
            att = (F.relu(h) + 1e-3)[:, 0::2]
        else:
            att = F.softplus(h)
        delta = _inv_attractor(att[:, None] - centers[:, :, None])  # [B, bins, attractors, H, W]
        delta = delta.mean(2) if c.attractor_kind == "mean" else delta.sum(2)
        new_centers = centers + delta
        if normed:
            scaled = (c.max_depth - c.min_depth) * new_centers + c.min_depth
            scaled = torch.clamp(torch.sort(scaled, dim=1).values, c.min_depth, c.max_depth)
            return new_centers, scaled
        return new_centers, new_centers


class SeedBinRegressor(nn.Module):
    def __init__(self, config: DepthConfig):
        super().__init__()
        c = self.config = config
        self.conv1 = _conv(c.bottleneck_features, 256, 1, c.dtype)
        self.conv2 = _conv(256, c.n_bins, 1, c.dtype)

    def forward(self, x):
        c = self.config
        h = self.conv2(F.relu(self.conv1(x)))
        if c.bin_centers_type == "normed":
            h = F.relu(h) + 1e-3
            widths_normed = h / h.sum(1, keepdim=True)
            widths = (c.max_depth - c.min_depth) * widths_normed
            edges = torch.cumsum(F.pad(widths, (0, 0, 0, 0, 1, 0), value=c.min_depth), dim=1)
            return widths_normed, 0.5 * (edges[:, :-1] + edges[:, 1:])
        h = F.softplus(h)
        return h, h


def log_binomial_constant(n_bins: int) -> np.ndarray:
    """log C(k-1, i) with the torch eps-Stirling formula
    (modeling_zoedepth.py:382-385), evaluated in float64 on the host: in
    float32 on the device it gives 0·log(0) = NaN at i = k-1."""
    e = 1e-7
    n = np.float64(n_bins - 1) + e
    r = np.arange(n_bins, dtype=np.float64) + e
    return (n * np.log(n) - r * np.log(r) - (n - r) * np.log(n - r + e)).astype(np.float32)


class ConditionalLogBinomial(nn.Module):
    """Per-pixel p/temperature MLP + log-binomial softmax over n_bins (HF
    ZoeDepthConditionalLogBinomialSoftmax)."""

    def __init__(self, config: DepthConfig, n_in: int):
        super().__init__()
        c = self.config = config
        self.mlp1 = _conv(n_in, n_in // 2, 1, c.dtype)
        self.mlp2 = _conv(n_in // 2, 4, 1, c.dtype)

    def forward(self, main, cond):
        c = self.config
        h = F.softplus(self.mlp2(F.gelu(self.mlp1(torch.cat([main, cond], dim=1)))))
        pt = h + 1e-4
        p = pt[:, 0] / (pt[:, 0] + pt[:, 1])
        t = pt[:, 2] / (pt[:, 2] + pt[:, 3])
        t = (c.max_temp - c.min_temp) * t + c.min_temp
        k = c.n_bins
        k_idx = torch.arange(k, dtype=torch.float32, device=h.device)[:, None, None]
        eps = 1e-4
        p = torch.clamp(p, eps, 1.0)[:, None]
        one_m = torch.clamp(1.0 - p, eps, 1.0)
        lb = torch.from_numpy(log_binomial_constant(k)).to(h.device)[:, None, None]
        y = lb + k_idx * torch.log(p) + (float(k - 1) - k_idx) * torch.log(one_m)
        return torch.softmax(y / t[:, None], dim=1)


class ZoeDepthModel(nn.Module):
    """Full depth net: pixels [B, 3, H, W] -> metric depth [B, H', W']."""

    def __init__(self, config: DepthConfig):
        super().__init__()
        c = self.config = config
        fh = c.fusion_hidden_size
        self.backbone = BeitBackbone(c.beit)
        self.reassemble = ReassembleStage(c)
        for i, ch in enumerate(c.neck_hidden_sizes):
            setattr(self, f"neck_conv{i}", _conv(ch, fh, 3, c.dtype, bias=False))
        for i in range(len(c.neck_hidden_sizes)):
            setattr(self, f"fusion{i}", FusionLayer(c, has_residual=i > 0))
        self.rel_conv1 = _conv(fh, fh // 2, 3, c.dtype)
        self.rel_conv2 = _conv(fh // 2, c.num_relative_features, 3, c.dtype)
        self.rel_conv3 = _conv(c.num_relative_features, 1, 1, c.dtype)
        self.mh_conv2 = _conv(fh, c.bottleneck_features, 1, c.dtype)
        self.seed_bin = SeedBinRegressor(c)
        self.seed_proj = Projector(c.bottleneck_features, c.bin_embedding_dim, c.dtype)
        for i, n_att in enumerate(c.num_attractors):
            setattr(self, f"mh_proj{i}", Projector(fh, c.bin_embedding_dim, c.dtype))
            setattr(self, f"attractor{i}", AttractorLayer(c, n_att))
        self.clb = ConditionalLogBinomial(c, c.num_relative_features + 1 + c.bin_embedding_dim)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        c = self.config
        taps, window = self.backbone(pixels)
        feats = [getattr(self, f"neck_conv{i}")(f) for i, f in enumerate(self.reassemble(taps, window))]
        bottleneck = feats[-1]

        # Fusion, deepest first (HF ZoeDepthFeatureFusionStage).
        fused, state = [], None
        for i, f in enumerate(feats[::-1]):
            layer = getattr(self, f"fusion{i}")
            state = layer(f) if state is None else layer(state, f)
            fused.append(state)

        # Relative head on the last (highest-resolution) fused map.
        h = self.rel_conv1(fused[-1])
        h = _resize(h, (h.shape[-2] * 2, h.shape[-1] * 2), align_corners=True)
        rel_features = F.relu(self.rel_conv2(h))
        rel_depth = F.relu(self.rel_conv3(rel_features))

        # Metric-bins head.
        x = self.mh_conv2(bottleneck)
        _, seed_centers = self.seed_bin(x)
        if c.bin_centers_type == "normed":
            prev_bin = (seed_centers - c.min_depth) / (c.max_depth - c.min_depth)
        else:
            prev_bin = seed_centers
        prev_emb = self.seed_proj(x)
        centers = emb = None
        for i, feat in enumerate(fused):
            emb = getattr(self, f"mh_proj{i}")(feat)
            prev_bin, centers = getattr(self, f"attractor{i}")(emb, prev_bin, prev_emb)
            prev_emb = emb

        rel_cond = _resize(rel_depth, rel_features.shape[-2:], align_corners=True)
        last = torch.cat([rel_features, rel_cond], dim=1)
        emb = _resize(emb, last.shape[-2:], align_corners=True)
        probs = self.clb(last, emb)
        centers = _resize(centers, probs.shape[-2:], align_corners=True)
        return (probs * centers).sum(1)


class MetricDepthEstimator:
    """Prediction front end (the torch.hub ZoeD_N's). Config None: ZoeD_N
    (`DepthConfig()`, fp32), with `use_flash` on the card (K5);
    FREEPOSE_TINY_MODELS=1 takes DEPTH_TEST. params: the JAX package's
    parameter tree (nested numpy), or None for seeded random parameters
    (models/convert.py:random_zoedepth_params)."""

    IMAGE_MEAN = (0.485, 0.456, 0.406)
    IMAGE_STD = (0.229, 0.224, 0.225)

    def __init__(self, config: DepthConfig | None = None, params=None, seed: int = 0, device=None):
        from freepose_tpu_torch.models.convert import random_zoedepth_params, zoedepth_from_jax

        self.device = resolve_device(device)
        if config is None:
            config = DEPTH_TEST if os.environ.get("FREEPOSE_TINY_MODELS") else DepthConfig()
            if config is not DEPTH_TEST and self.device.type == "cuda":
                config = dataclasses.replace(config, beit=dataclasses.replace(config.beit, use_flash=True))
        self.config = config
        if params is None:
            params = random_zoedepth_params(config, seed)
        with torch.device("meta"):
            model = ZoeDepthModel(config)
        model.to_empty(device=self.device)
        model.load_state_dict(zoedepth_from_jax(params))
        self.model = model.eval()

    @classmethod
    def from_weights(cls, weights_path: str | None, config: DepthConfig | None = None, device=None):
        from freepose_tpu_torch.models.convert import load_params

        return cls(config, params=load_params(weights_path) if weights_path else None, device=device)

    @torch.inference_mode()
    def predict(self, image: np.ndarray, input_hw: tuple[int, int] | None = None) -> np.ndarray:
        """[H, W, 3] uint8/float -> [H, W] metric depth (metres). input_hw
        overrides the model resolution (multiples of the patch size; the
        relative position tables resize to a non-pretrain window)."""
        h, w = image.shape[:2]
        img = torch.tensor(image, dtype=torch.float32, device=self.device)
        if image.dtype == np.uint8:
            img = img / 255.0
        size = self.config.image_size
        ih, iw = input_hw or (size, size)
        patch = self.config.beit.patch_size
        if ih % patch or iw % patch:
            raise ValueError(f"input_hw must be multiples of {patch}, got {(ih, iw)}")
        resized = resize_bilinear(img.permute(2, 0, 1), (ih, iw))
        mean = torch.tensor(self.IMAGE_MEAN, device=self.device).reshape(3, 1, 1)
        std = torch.tensor(self.IMAGE_STD, device=self.device).reshape(3, 1, 1)
        depth = self.model(((resized - mean) / std)[None])[0]
        return resize_bilinear(depth, (h, w)).cpu().numpy()
