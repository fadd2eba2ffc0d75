"""Seeded random weights, made by the benchmark and handed alike to the
program and to the reference.

The parameters are those of a frozen reference module (the spec), by name:
one draw of standard normals on the device from the seed, cut into the
parameters in name order, each scaled by a rule on its name and module:
lecun-normal weights (fan-in from the torch layout), biases N(0, 0.02) (the
SAM2 object-score head's output bias +10, so that a random SAM2 keeps its
object), norm scales 1 + N(0, 0.02), LayerScale 0.1, the prompt encoder's
Fourier matrix N(0, 1), other parameters N(0, 0.02). Every value is rounded
to the served dtype, so both sides hold the same numbers."""
from __future__ import annotations

import math

import torch
from torch import nn

OBJECT_SCORE_BIAS = 10.0
LAYERSCALE = 0.1



def _value(name: str, parent: nn.Module, z: torch.Tensor) -> torch.Tensor:
    leaf = name.rsplit(".", 1)[-1]
    shape = z.shape
    if leaf == "bias":
        v = 0.02 * z
        if name.endswith("obj_head.proj_out.bias"):
            v = v + OBJECT_SCORE_BIAS
        return v
    if leaf == "weight" and isinstance(parent, (nn.LayerNorm, nn.GroupNorm)):
        return 1.0 + 0.02 * z
    if leaf == "gamma":
        return torch.full_like(z, LAYERSCALE)
    if leaf == "pe_matrix":
        return z
    if leaf == "weight" and z.ndim >= 2:
        fan_in = shape[0] * math.prod(shape[2:]) if isinstance(parent, nn.ConvTranspose2d) else math.prod(shape[1:])
        return z / math.sqrt(fan_in)
    return 0.02 * z


def make_weights(spec: nn.Module, seed: int, device, served: torch.dtype) -> dict[str, torch.Tensor]:
    """{name: fp32 tensor on `device`} for every parameter of `spec` (its
    shapes only are read; it may live on the meta device)."""
    named = sorted((n, tuple(p.shape)) for n, p in spec.named_parameters())
    total = sum(math.prod(s) for _, s in named)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2**63))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape in named:
        n = math.prod(shape)
        parent = spec.get_submodule(name.rsplit(".", 1)[0]) if "." in name else spec
        out[name] = _value(name, parent, flat[at:at + n].reshape(shape)).to(served).float()
        at += n
    return out


def load_into(module: nn.Module, weights: dict[str, torch.Tensor]) -> None:
    """Copy `weights` into `module`'s parameters (each in its own dtype);
    every parameter must be covered, and nothing else given."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        missing, extra = sorted(set(params) - set(weights)), sorted(set(weights) - set(params))
        raise KeyError(f"weights do not match the module: missing {missing[:5]}, extra {extra[:5]}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(weights[name])
