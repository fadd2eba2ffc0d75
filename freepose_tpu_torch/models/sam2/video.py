"""SAM2 video tracking with a fixed-capacity memory state, as nn.Modules.

Counterpart of freepose_tpu.models.sam2.video. Per object the state holds

  * 7 spatial mask-memory slots (slot 0 = the conditioning frame, slots
    1..6 a ring of the most recent tracked frames), each [HW_mem, 64]; with
    a memory stride r > 1 slot 1 holds the last frame and slots 2..6 a ring
    of the newest frames on the r-grid;
  * 16 object-pointer slots (slot 0 = the conditioning pointer, 1..15 a
    ring);
  * validity masks and frame indices for both.

The JAX package steps one object and vmaps over objects; here every tensor
of the state and every step carry the objects of one prompt group on the
leading axis, so memory attention runs at batch = objects (on the card:
self-attention [O, 1, 4096, 256] through kernel K2, cross-attention over
28,736 keys through kernel K4). A state is updated in place.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from freepose_tpu_torch.models.sam2.hiera import sine_position_encoding
from freepose_tpu_torch.models.layers import Conv, Dense
from freepose_tpu_torch.models.sam2.mask_decoder import FeedForwardN
from freepose_tpu_torch.models.sam2.memory import MemoryAttention, MemoryConfig, MemoryEncoder, sine_1d_pe
from freepose_tpu_torch.models.sam2.model import Sam2Config, Sam2ImageModel
from freepose_tpu_torch.ops.sampling import resize_bilinear
from freepose_tpu_torch.utils import timing

NO_OBJ_SCORE = -1024.0


@dataclasses.dataclass(frozen=True)
class Sam2VideoConfig:
    sam: Sam2Config = Sam2Config()
    mem: MemoryConfig = MemoryConfig()
    image_size: int = 1024
    mem_grid: int = 64  # memory feature side = image_size / 16
    enable_occlusion_embedding: bool = True
    enable_ptr_temporal_pos: bool = True
    multimask_for_tracking: bool = True
    max_point_prompts: int = 8  # static pad for point prompts


@dataclasses.dataclass
class ObjectState:
    """Fixed-capacity tracking memory of O objects stepped together."""

    maskmem: torch.Tensor  # [O, num_maskmem, HW_mem, mem_dim] fp32
    maskmem_frame: torch.Tensor  # [O, num_maskmem] int64 frame index of each slot
    maskmem_valid: torch.Tensor  # [O, num_maskmem] bool
    ptrs: torch.Tensor  # [O, max_ptrs, hidden] fp32
    ptr_frame: torch.Tensor  # [O, max_ptrs] int64
    ptr_valid: torch.Tensor  # [O, max_ptrs] bool
    ring_pos: int = 1  # next non-cond mask-memory slot (1..num_maskmem-1; 2.. when the stride is > 1)
    ptr_ring_pos: int = 1  # next non-cond pointer slot (1..max_ptrs-1)
    last_frame: int | None = None  # stride > 1: the frame slot 1 holds (None while it is empty)

    @property
    def n_objects(self) -> int:
        return int(self.maskmem.shape[0])


def init_object_state(cfg: Sam2VideoConfig, n_objects: int = 1, device=None) -> ObjectState:
    m = cfg.mem
    hw = cfg.mem_grid * cfg.mem_grid
    o = n_objects
    return ObjectState(
        maskmem=torch.zeros((o, m.num_maskmem, hw, m.mem_dim), device=device),
        maskmem_frame=torch.full((o, m.num_maskmem), -1, dtype=torch.int64, device=device),
        maskmem_valid=torch.zeros((o, m.num_maskmem), dtype=torch.bool, device=device),
        ptrs=torch.zeros((o, m.max_obj_ptrs, m.hidden_size), device=device),
        ptr_frame=torch.full((o, m.max_obj_ptrs), -1, dtype=torch.int64, device=device),
        ptr_valid=torch.zeros((o, m.max_obj_ptrs), dtype=torch.bool, device=device),
        ring_pos=1 if m.memory_temporal_stride == 1 else 2,
    )


class Sam2VideoModel(nn.Module):
    def __init__(self, config: Sam2VideoConfig):
        super().__init__()
        c = self.config = config
        m = c.mem
        self.image = Sam2ImageModel(c.sam)
        self.memory_attention = MemoryAttention(m)
        self.memory_encoder = MemoryEncoder(m, in_dim=c.sam.fpn_dim)
        self.memory_temporal_pos = nn.Parameter(torch.zeros(m.num_maskmem, 1, 1, m.mem_dim))
        self.no_object_pointer = nn.Parameter(torch.zeros(1, m.hidden_size))
        self.no_memory_pos = nn.Parameter(torch.zeros(1, 1, m.hidden_size))
        self.obj_ptr_proj = FeedForwardN(c.sam.decoder.hidden_size, m.hidden_size, m.hidden_size, 3)
        if c.enable_ptr_temporal_pos:
            self.ptr_tpos_proj = Dense(m.hidden_size, m.mem_dim)
        if c.enable_occlusion_embedding:
            self.occlusion_embedding = nn.Parameter(torch.zeros(1, m.mem_dim))
        self.mask_downsample = Conv(1, 1, 4, stride=4)

    def embed_frame(self, pixels: torch.Tensor):
        """Normalised [K, 3, S, S] frames -> (pyramid [s0', s1', s2_raw], pos).
        s0'/s1' carry the SAM-head projections; s2_raw has no no-memory
        embedding (memory conditioning decides)."""
        return self.image.embed_image(pixels, with_memory_placeholder=False)

    def _gather_memory(self, state: ObjectState, frame_idx: int, num_frames: int, reverse: bool):
        """Padded memory tokens, positions and validity for attention:
        ([O, M, mem_dim], [O, M, mem_dim], [O, M] bool, pointer tokens)."""
        c = self.config
        m = c.mem
        dev = state.maskmem.device
        o = state.n_objects
        hw = c.mem_grid * c.mem_grid
        sign = -1 if reverse else 1

        is_cond = torch.arange(m.num_maskmem, device=dev) == 0
        r = m.memory_temporal_stride
        if r == 1:
            t_rel = sign * (frame_idx - state.maskmem_frame)  # [O, S]
            valid = state.maskmem_valid & (is_cond | ((t_rel >= 1) & (t_rel <= m.num_maskmem - 1)))
        else:
            # The stride-r selection in virtual time v = sign * frame (one
            # formula forward and reverse): the last frame at t_rel 1, then
            # the frames anchor - k·r at t_rel 2 + k, anchor = ((v-2)//r)·r.
            v = sign * frame_idx
            vj = sign * state.maskmem_frame
            anchor = ((v - 2) // r) * r
            is_last = vj == v - 1
            on_grid = (vj % r == 0) & (vj <= anchor)
            t_rel = torch.where(is_last, 1, 2 + torch.div(anchor - vj, r, rounding_mode="floor"))
            valid = state.maskmem_valid & (is_cond | is_last | (on_grid & (t_rel <= m.num_maskmem - 1)))
        # The conditioning slot takes temporal-position row -1, the others
        # row t_rel - 1.
        tpos_idx = torch.where(is_cond, m.num_maskmem - 1, torch.clamp(t_rel - 1, 0, m.num_maskmem - 1))
        spatial_pos = sine_position_encoding((c.mem_grid, c.mem_grid), m.mem_dim, device=dev).reshape(hw, m.mem_dim)
        tpos = self.memory_temporal_pos[tpos_idx, 0, 0]  # [O, S, mem_dim]
        mem_tokens = state.maskmem.reshape(o, m.num_maskmem * hw, m.mem_dim)
        mem_pos = (spatial_pos[None, None] + tpos[:, :, None]).reshape(o, m.num_maskmem * hw, m.mem_dim)
        mem_mask = valid.repeat_interleave(hw, dim=1)

        # Object pointers: the conditioning pointer (any past offset) and the
        # ring within max_obj_ptrs - 1 frames.
        p_off = sign * (frame_idx - state.ptr_frame)  # [O, P]
        p_is_cond = torch.arange(m.max_obj_ptrs, device=dev) == 0
        max_ptrs_use = min(num_frames, m.max_obj_ptrs)
        p_valid = state.ptr_valid & (p_off >= 0) & (p_is_cond | ((p_off >= 1) & (p_off <= max_ptrs_use - 1)))
        if c.enable_ptr_temporal_pos:
            tdiff = p_off.float() / max(max_ptrs_use - 1.0, 1.0)
            ptr_pos = self.ptr_tpos_proj(sine_1d_pe(tdiff, m.hidden_size))  # [O, P, mem_dim]
        else:
            ptr_pos = torch.zeros((o, m.max_obj_ptrs, m.mem_dim), device=dev)
        splits = m.hidden_size // m.mem_dim
        ptr_tokens = state.ptrs.reshape(o, m.max_obj_ptrs * splits, m.mem_dim)
        ptr_pos_tokens = ptr_pos.repeat_interleave(splits, dim=1)
        ptr_mask = p_valid.repeat_interleave(splits, dim=1)

        memory = torch.cat([mem_tokens, ptr_tokens], dim=1)
        memory_pos = torch.cat([mem_pos, ptr_pos_tokens], dim=1)
        kv_mask = torch.cat([mem_mask, ptr_mask], dim=1)
        return memory, memory_pos, kv_mask, m.max_obj_ptrs * splits

    def _sam_step(self, pyramid, points, labels, mask_prompt, multimask: bool):
        """SAM heads on a (memory-conditioned) pyramid -> (best low-res mask
        [O, 4G, 4G], high-res mask [O, S, S] fp32, pointer [O, hidden],
        object logits [O, 1], iou [O, M])."""
        c = self.config
        masks, iou, sam_tokens, obj_logits = self.image.decode_masks(
            pyramid, points=points, labels=labels, mask_inputs=mask_prompt, multimask_output=multimask)
        masks, iou, sam_tokens, obj_logits = masks[:, 0], iou[:, 0], sam_tokens[:, 0], obj_logits[:, 0]
        is_obj = obj_logits[:, 0] > 0  # [O]
        masks = torch.where(is_obj[:, None, None, None], masks,
                            torch.full((), NO_OBJ_SCORE, dtype=masks.dtype, device=masks.device))
        high_res = resize_bilinear(masks, (c.image_size, c.image_size))
        if multimask:
            rows = torch.arange(masks.shape[0], device=masks.device)
            best = iou.argmax(dim=-1)
            low_res_mask, high_res_mask, token = masks[rows, best], high_res[rows, best], sam_tokens[rows, best]
        else:
            low_res_mask, high_res_mask, token = masks[:, 0], high_res[:, 0], sam_tokens[:, 0]
        pointer = self.obj_ptr_proj(token)
        lam = is_obj[:, None].to(pointer.dtype)
        pointer = lam * pointer + (1 - lam) * self.no_object_pointer
        return low_res_mask, high_res_mask, pointer, obj_logits, iou

    def _mask_as_output(self, pyramid, mask_inputs: torch.Tensor):
        """A given binary mask [O, S, S] as the output; the pointer comes
        from the decoder fed with the downsampled mask prompt."""
        c = self.config
        out_scale, out_bias = 20.0, -10.0
        high_res = mask_inputs.float() * out_scale + out_bias
        g4 = c.image_size // 4
        low_res = resize_bilinear(high_res, (g4, g4))
        mask_prompt = self.mask_downsample(high_res[..., None]).permute(0, 3, 1, 2)
        _, _, pointer, _, _ = self._sam_step(pyramid, None, None, mask_prompt, multimask=False)
        is_obj = (mask_inputs.reshape(mask_inputs.shape[0], -1) > 0).any(dim=-1)
        lam = is_obj[:, None].to(pointer.dtype)
        pointer = lam * pointer + (1 - lam) * self.no_object_pointer
        return low_res, high_res, pointer, out_scale * lam + out_bias

    def encode_memory(self, raw_s2, high_res_mask, obj_logits, binarize: bool) -> torch.Tensor:
        """raw_s2 [O, G, G, C] (no memory embedding), high_res_mask [O, S, S]
        -> [O, HW_mem, mem_dim] fp32 memory tokens."""
        c = self.config
        m = c.mem
        mask_for_mem = (high_res_mask > 0).to(high_res_mask.dtype) if binarize else torch.sigmoid(high_res_mask)
        mask_for_mem = mask_for_mem * m.sigmoid_scale + m.sigmoid_bias
        feats, _ = self.memory_encoder(raw_s2, mask_for_mem[..., None])
        feats = feats.float()
        if c.enable_occlusion_embedding:
            is_obj = (obj_logits[:, 0] > 0).float()
            feats = feats + (1.0 - is_obj)[:, None, None, None] * self.occlusion_embedding[0]
        return feats.reshape(feats.shape[0], -1, m.mem_dim)

    def track_step(self, state: ObjectState, pyramid, raw_s2, pos_s2, frame_idx: int, num_frames: int,
                   points=None, labels=None, mask_inputs=None, is_init: bool = False, reverse: bool = False,
                   multimask: bool | None = None):
        """One tracking step for the O objects of `state` on one frame.
        pyramid / raw_s2 / pos_s2 are the frame's (batch 1, shared by the
        objects); points [O, 1, N, 2] and labels [O, 1, N], or mask_inputs
        [O, S, S], prompt an init step. Updates `state` in place and returns
        (state, outputs)."""
        c = self.config
        m = c.mem
        g = c.mem_grid
        o = state.n_objects
        p0 = pyramid[0].expand(o, *pyramid[0].shape[1:])
        p1 = pyramid[1].expand(o, *pyramid[1].shape[1:])
        raw = raw_s2.expand(o, *raw_s2.shape[1:])
        no_mem = self.image.no_memory_embedding[0, 0].to(raw.dtype)

        if mask_inputs is not None:
            with timing.span("sam2.decoder"):
                low_res, high_res, pointer, obj_logits = self._mask_as_output([p0, p1, raw + no_mem], mask_inputs)
            iou = torch.ones((o, 1), device=raw.device)
        else:
            if is_init:
                pix = raw + no_mem
            else:
                with timing.span("sam2.memory_gather"):
                    memory, memory_pos, kv_mask, n_ptr = self._gather_memory(state, frame_idx, num_frames, reverse)
                with timing.span("sam2.memory_attention"):
                    curr = raw.reshape(o, g * g, m.hidden_size)
                    curr_pos = pos_s2.reshape(1, g * g, m.hidden_size).expand(o, -1, -1)
                    pix = self.memory_attention(curr, curr_pos, memory, memory_pos, n_ptr, kv_mask)
                    pix = pix.reshape(o, g, g, m.hidden_size)
            if multimask is None:
                n_pts = 0 if points is None else points.shape[2]
                multimask = (is_init or c.multimask_for_tracking) and n_pts <= 1
            with timing.span("sam2.decoder"):
                low_res, high_res, pointer, obj_logits, iou = self._sam_step([p0, p1, pix], points, labels, None,
                                                                            multimask)

        with timing.span("sam2.memory_encoder"):
            mem_tokens = self.encode_memory(raw, high_res, obj_logits,
                                            points is not None or mask_inputs is not None)
        r = m.memory_temporal_stride
        if is_init:
            slot, pslot = 0, 0
        elif r == 1:
            slot, pslot = state.ring_pos, state.ptr_ring_pos
            state.ring_pos = 1 if slot + 1 >= m.num_maskmem else slot + 1
            state.ptr_ring_pos = 1 if pslot + 1 >= m.max_obj_ptrs else pslot + 1
        else:
            # Stride r: slot 1 always takes the newest frame; the frame it
            # evicts enters the ring of slots 2..num_maskmem-1 only if it lies
            # on the r-grid. Pointers do not depend on the stride.
            old = state.last_frame
            if old is not None and old % r == 0:
                ring = state.ring_pos
                state.maskmem[:, ring] = state.maskmem[:, 1]
                state.maskmem_frame[:, ring] = state.maskmem_frame[:, 1]
                state.maskmem_valid[:, ring] = state.maskmem_valid[:, 1]
                state.ring_pos = 2 if ring + 1 >= m.num_maskmem else ring + 1
            slot, pslot = 1, state.ptr_ring_pos
            state.last_frame = frame_idx
            state.ptr_ring_pos = 1 if pslot + 1 >= m.max_obj_ptrs else pslot + 1
        state.maskmem[:, slot] = mem_tokens
        state.maskmem_frame[:, slot] = frame_idx
        state.maskmem_valid[:, slot] = True
        state.ptrs[:, pslot] = pointer.float()
        state.ptr_frame[:, pslot] = frame_idx
        state.ptr_valid[:, pslot] = True
        outputs = {"pred_masks": low_res, "high_res_masks": high_res, "object_pointer": pointer,
                   "object_score_logits": obj_logits, "iou_scores": iou}
        return state, outputs
