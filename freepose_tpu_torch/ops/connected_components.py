"""Connected components by iterative min-label propagation, in plain PyTorch.

Counterpart of freepose_tpu.ops.connected_components (none of it is a Pallas
kernel there): every foreground pixel starts with its linear index, then
{4-neighbour min, pointer jump label <- label[label]} repeats until nothing
changes, so each label ends as the smallest linear index of its 4-connected
component; background is -1. Areas come from one bincount. Integer
arithmetic throughout, so the labels equal the JAX package's exactly.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_BIG = 2**30


def label_components(mask: torch.Tensor) -> torch.Tensor:
    """[H, W] bool -> int32 labels (min linear index of each 4-connected
    component; background = -1)."""
    h, w = mask.shape
    mask = mask.to(torch.bool)
    big = torch.full((), _BIG, dtype=torch.int32, device=mask.device)
    idx = torch.arange(h * w, dtype=torch.int32, device=mask.device).reshape(h, w)
    labels = torch.where(mask, idx, big)
    while True:
        padded = F.pad(labels[None], (1, 1, 1, 1), value=_BIG)[0]
        m = torch.minimum(torch.minimum(padded[:-2, 1:-1], padded[2:, 1:-1]),
                          torch.minimum(padded[1:-1, :-2], padded[1:-1, 2:]))
        new = torch.where(mask, torch.minimum(labels, m), big).reshape(-1)
        safe = torch.where(new >= _BIG, 0, new).long()
        new = torch.where(new >= _BIG, new, new[safe]).reshape(h, w)
        if torch.equal(new, labels):
            break
        labels = new
    return torch.where(mask, labels, -1)


def component_areas(labels: torch.Tensor) -> torch.Tensor:
    """int32 labels -> per-pixel area of the pixel's component [H, W] (0 on
    background)."""
    h, w = labels.shape
    flat = labels.reshape(-1).long()
    seg = torch.where(flat < 0, h * w, flat)  # park background in an extra bin
    counts = torch.bincount(seg, minlength=h * w + 1).to(torch.int32)
    return torch.where(flat < 0, 0, counts[seg]).reshape(h, w)


def largest_component(mask: torch.Tensor) -> torch.Tensor:
    """[H, W] bool -> bool mask of the largest 4-connected component; among
    components of equal area the one with the smallest label."""
    mask = mask.to(torch.bool)
    labels = label_components(mask)
    areas = component_areas(labels)
    candidate = torch.where(areas == areas.max(), labels, _BIG)
    best_label = torch.where(mask, candidate, _BIG).min()
    return labels == best_label


def remove_small_components(mask: torch.Tensor, max_area: int, fill_holes: bool = True) -> torch.Tensor:
    """Fill background holes of at most max_area pixels (fill_holes), then
    remove foreground components of at most max_area pixels (the two uses
    of SAM2's CUDA connected-components kernel)."""
    out = mask.to(torch.bool)
    if fill_holes:
        out = out | ((~out) & (component_areas(label_components(~out)) <= max_area))
    return out & (component_areas(label_components(out)) > max_area)


def connected_components_batch(masks: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[N, H, W] bool -> (labels [N, H, W] int32, areas [N, H, W] int32)."""
    labels = [label_components(m) for m in masks]
    return torch.stack(labels), torch.stack([component_areas(lab) for lab in labels])
