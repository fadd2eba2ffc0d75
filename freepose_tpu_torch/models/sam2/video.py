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

On a card, under inference mode, a prompt-free step at memory stride 1
replays CUDA graphs (_TrackGraph, utils/cuda_graphs.py) from its key's
second step on: three graphs in one pool (memory gather and attention; the
SAM heads; the memory encoder and the state's slot writes), the eager
step's kernels in its order, so the host launches three graphs a frame
where it launched some hundreds of kernels. The frame index and the two
ring slots reach the graphs as device scalars (`fill_`), the frame's
pyramid as copies into static buffers; the Python ring positions advance
as in an eager step. Every other step (the CPU, an init step, a prompt, a
stride above 1, outside inference mode) runs eagerly.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch import nn

from freepose_tpu_torch.models.sam2.hiera import sine_position_encoding
from freepose_tpu_torch.models.layers import Conv, Dense
from freepose_tpu_torch.models.sam2.mask_decoder import FeedForwardN
from freepose_tpu_torch.models.sam2.memory import MemoryAttention, MemoryConfig, MemoryEncoder, sine_1d_pe
from freepose_tpu_torch.models.sam2.model import Sam2Config, Sam2ImageModel
from freepose_tpu_torch.ops.sampling import resize_bilinear
from freepose_tpu_torch.utils import timing
from freepose_tpu_torch.utils.cuda_graphs import GraphCache, capture

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


STATE_TENSORS = ("maskmem", "maskmem_frame", "maskmem_valid", "ptrs", "ptr_frame", "ptr_valid")


def write_memory(state: ObjectState, frame_idx, slot, pslot, mem_tokens: torch.Tensor, pointer: torch.Tensor):
    """Memory tokens [O, HW_mem, mem_dim] into mask-memory slot `slot` and
    the pointer [O, hidden] into pointer slot `pslot` of `state`, both
    stamped with `frame_idx` and valid. Python ints (an eager step), or
    int64 device tensors (a 0-dim frame, [1] slots: a graphed step, written
    through index ops); the same values either way."""
    if isinstance(slot, int):
        state.maskmem[:, slot] = mem_tokens
        state.maskmem_frame[:, slot] = frame_idx
        state.maskmem_valid[:, slot] = True
        state.ptrs[:, pslot] = pointer.float()
        state.ptr_frame[:, pslot] = frame_idx
        state.ptr_valid[:, pslot] = True
        return
    stamp = frame_idx.reshape(1, 1).expand(mem_tokens.shape[0], 1)
    state.maskmem.index_copy_(1, slot, mem_tokens[:, None])
    state.maskmem_frame.index_copy_(1, slot, stamp)
    state.maskmem_valid.index_fill_(1, slot, True)
    state.ptrs.index_copy_(1, pslot, pointer.float()[:, None])
    state.ptr_frame.index_copy_(1, pslot, stamp)
    state.ptr_valid.index_fill_(1, pslot, True)


def track_graph_key(config: Sam2VideoConfig, device: torch.device, n_objects: int, dtype: torch.dtype,
                    is_init: bool, prompted: bool, reverse: bool, multimask: bool, num_frames: int):
    """The key of the CUDA graphs that replay a tracking step, or None (the
    step runs eagerly). Only a prompt-free step (not an init step, no points,
    no mask) at memory stride 1 on a card under inference mode replays; a
    stride above 1 moves slots by host branches. The key holds what a replay
    depends on and a step can see: the device, the object count, the dtype,
    the sweep's direction, the multimask choice, the pointers' window
    (max_ptrs_use) and the memory attention's function, so a swapped
    function never replays the former one."""
    if (device.type != "cuda" or is_init or prompted or config.mem.memory_temporal_stride != 1
            or not torch.is_inference_mode_enabled()):
        return None
    from freepose_tpu_torch.ops import attention

    attend = attention.flash_attention_auto if config.mem.use_flash else None
    return (device, n_objects, dtype, reverse, multimask, min(num_frames, config.mem.max_obj_ptrs), attend)


class _TrackGraph:
    """One key's prompt-free tracking step as three CUDA graphs in one
    pool, over static buffers: `attend` (memory gather and attention),
    `decode` (the SAM heads) and `remember` (the memory encoder and the
    slot writes). The graphs read and write the state tensors of `state`,
    which an ObjectState stepping here adopts (`_adopt`). A step copies
    its frame's pyramid into the buffers and its frame index and slots into
    device scalars, replays the three, and returns copies of the outputs,
    which the next replay overwrites. pos_s2, the neck's sine positions (a
    function of the shape), is read once, at the capture."""

    def __init__(self, model: "Sam2VideoModel", state: ObjectState, pyramid, raw_s2, pos_s2, num_frames: int,
                 reverse: bool, multimask: bool):
        dev, o = raw_s2.device, state.n_objects
        self.p0, self.p1, self.raw, self.pos = (x.clone() for x in (pyramid[0], pyramid[1], raw_s2, pos_s2))
        self.frame = torch.zeros((), dtype=torch.int64, device=dev)
        self.slot = torch.ones(1, dtype=torch.int64, device=dev)
        self.pslot = torch.ones(1, dtype=torch.int64, device=dev)
        self.state = ObjectState(*(getattr(state, f).clone() for f in STATE_TENSORS))
        self.owner = None  # a weak reference to the ObjectState holding self.state's tensors

        def expand(x):
            return x.expand(o, *x.shape[1:])

        def attend():
            memory = model._gather_memory(self.state, self.frame, num_frames, reverse)
            self.pix = model._condition(expand(self.raw), self.pos, *memory)

        def decode():
            self.out = model._sam_step([expand(self.p0), expand(self.p1), self.pix], None, None, None, multimask)

        def remember():
            _, high_res, pointer, obj_logits, _ = self.out
            mem_tokens = model.encode_memory(expand(self.raw), high_res, obj_logits, False)
            write_memory(self.state, self.frame, self.slot, self.pslot, mem_tokens, pointer)

        def warm_up():  # writes the static state, which `_adopt` overwrites before the first replay
            attend()
            decode()
            remember()

        self.attend, self.decode, self.remember = capture(dev, warm_up, attend, decode, remember)
        timing.count("sam2.graph_captures")

    def _adopt(self, state: ObjectState) -> None:
        """Point `state` at the graphs' state tensors, its values copied in;
        a former owner that still holds them gets copies of them first."""
        mine = [getattr(self.state, f) for f in STATE_TENSORS]
        if all(getattr(state, f) is t for f, t in zip(STATE_TENSORS, mine)):
            return
        former = self.owner() if self.owner is not None else None
        if former is not None and all(getattr(former, f) is t for f, t in zip(STATE_TENSORS, mine)):
            for f, t in zip(STATE_TENSORS, mine):
                setattr(former, f, t.clone())
        for f, t in zip(STATE_TENSORS, mine):
            t.copy_(getattr(state, f))
            setattr(state, f, t)
        self.owner = weakref.ref(state)

    def __call__(self, state: ObjectState, pyramid, raw_s2, frame_idx: int, slot: int, pslot: int) -> dict:
        with timing.span("sam2.memory_gather"):
            self._adopt(state)
            for dst, src in ((self.p0, pyramid[0]), (self.p1, pyramid[1]), (self.raw, raw_s2)):
                dst.copy_(src)
            self.frame.fill_(frame_idx)
            self.slot.fill_(slot)
            self.pslot.fill_(pslot)
        with timing.span("sam2.memory_attention"):
            self.attend.replay()
        with timing.span("sam2.decoder"):
            self.decode.replay()
            low_res, high_res, pointer, obj_logits, iou = (x.clone() for x in self.out)
        with timing.span("sam2.memory_encoder"):
            self.remember.replay()
        timing.count("sam2.graph_replays")
        return {"pred_masks": low_res, "high_res_masks": high_res, "object_pointer": pointer,
                "object_score_logits": obj_logits, "iou_scores": iou}


class Sam2VideoModel(nn.Module):
    def __init__(self, config: Sam2VideoConfig):
        super().__init__()
        self._graphs = GraphCache()
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

    def _apply(self, fn, *args, **kwargs):
        self._graphs.clear()  # a graph replays the parameter tensors of its capture
        return super()._apply(fn, *args, **kwargs)

    def embed_frame(self, pixels: torch.Tensor):
        """Normalised [K, 3, S, S] frames -> (pyramid [s0', s1', s2_raw], pos).
        s0'/s1' carry the SAM-head projections; s2_raw has no no-memory
        embedding (memory conditioning decides)."""
        return self.image.embed_image(pixels, with_memory_placeholder=False)

    def _gather_memory(self, state: ObjectState, frame_idx, num_frames: int, reverse: bool):
        """Padded memory tokens, positions and validity for attention:
        ([O, M, mem_dim], [O, M, mem_dim], [O, M] bool, pointer tokens).
        frame_idx: a Python int, or a 0-dim int64 tensor on the state's
        device (a graphed step); the same values either way."""
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

    def _condition(self, raw, pos_s2, memory, memory_pos, kv_mask, n_ptr: int) -> torch.Tensor:
        """The frame's raw_s2 [O, G, G, C] conditioned on the gathered memory
        (`_gather_memory`'s outputs) by memory attention -> [O, G, G, C]."""
        m, g = self.config.mem, self.config.mem_grid
        o = raw.shape[0]
        curr = raw.reshape(o, g * g, m.hidden_size)
        curr_pos = pos_s2.reshape(1, g * g, m.hidden_size).expand(o, -1, -1)
        pix = self.memory_attention(curr, curr_pos, memory, memory_pos, n_ptr, kv_mask)
        return pix.reshape(o, g, g, m.hidden_size)

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

    def _next_slots(self, state: ObjectState, frame_idx: int, is_init: bool) -> tuple[int, int]:
        """The mask-memory and pointer slots this step writes; advances the
        state's rings. At a stride above 1 it first moves slot 1's frame into
        the ring if that frame lies on the r-grid, so it runs after the
        step's gather."""
        m = self.config.mem
        r = m.memory_temporal_stride
        if is_init:
            return 0, 0
        pslot = state.ptr_ring_pos
        state.ptr_ring_pos = 1 if pslot + 1 >= m.max_obj_ptrs else pslot + 1
        if r == 1:
            slot = state.ring_pos
            state.ring_pos = 1 if slot + 1 >= m.num_maskmem else slot + 1
            return slot, pslot
        # Stride r: slot 1 always takes the newest frame; the frame it evicts
        # enters the ring of slots 2..num_maskmem-1 only if it lies on the
        # r-grid. Pointers do not depend on the stride.
        old = state.last_frame
        if old is not None and old % r == 0:
            ring = state.ring_pos
            state.maskmem[:, ring] = state.maskmem[:, 1]
            state.maskmem_frame[:, ring] = state.maskmem_frame[:, 1]
            state.maskmem_valid[:, ring] = state.maskmem_valid[:, 1]
            state.ring_pos = 2 if ring + 1 >= m.num_maskmem else ring + 1
        state.last_frame = frame_idx
        return 1, pslot

    def track_step(self, state: ObjectState, pyramid, raw_s2, pos_s2, frame_idx: int, num_frames: int,
                   points=None, labels=None, mask_inputs=None, is_init: bool = False, reverse: bool = False,
                   multimask: bool | None = None):
        """One tracking step for the O objects of `state` on one frame.
        pyramid / raw_s2 / pos_s2 are the frame's (batch 1, shared by the
        objects); points [O, 1, N, 2] and labels [O, 1, N], or mask_inputs
        [O, S, S], prompt an init step. Updates `state` in place and returns
        (state, outputs). A step `track_graph_key` keys replays its key's
        graphs from the key's second step on (_TrackGraph: `state` then holds
        the graphs' state tensors; the outputs are copies)."""
        c = self.config
        o = state.n_objects
        if multimask is None:
            n_pts = 0 if points is None else points.shape[2]
            multimask = (is_init or c.multimask_for_tracking) and n_pts <= 1
        prompted = points is not None or mask_inputs is not None
        key = track_graph_key(c, raw_s2.device, o, raw_s2.dtype, is_init, prompted, reverse, multimask, num_frames)
        graph = None if key is None else self._graphs.get(
            key, lambda: _TrackGraph(self, state, pyramid, raw_s2, pos_s2, num_frames, reverse, multimask))
        if graph is not None:
            slot, pslot = self._next_slots(state, frame_idx, is_init)
            return state, graph(state, pyramid, raw_s2, frame_idx, slot, pslot)

        p0 = pyramid[0].expand(o, *pyramid[0].shape[1:])
        p1 = pyramid[1].expand(o, *pyramid[1].shape[1:])
        raw = raw_s2.expand(o, *raw_s2.shape[1:])
        if mask_inputs is not None:
            no_mem = self.image.no_memory_embedding[0, 0].to(raw.dtype)
            with timing.span("sam2.decoder"):
                low_res, high_res, pointer, obj_logits = self._mask_as_output([p0, p1, raw + no_mem], mask_inputs)
            iou = torch.ones((o, 1), device=raw.device)
        else:
            if is_init:
                pix = raw + self.image.no_memory_embedding[0, 0].to(raw.dtype)
            else:
                with timing.span("sam2.memory_gather"):
                    memory = self._gather_memory(state, frame_idx, num_frames, reverse)
                with timing.span("sam2.memory_attention"):
                    pix = self._condition(raw, pos_s2, *memory)
            with timing.span("sam2.decoder"):
                low_res, high_res, pointer, obj_logits, iou = self._sam_step([p0, p1, pix], points, labels, None,
                                                                            multimask)

        with timing.span("sam2.memory_encoder"):
            mem_tokens = self.encode_memory(raw, high_res, obj_logits, prompted)
            slot, pslot = self._next_slots(state, frame_idx, is_init)
            write_memory(state, frame_idx, slot, pslot, mem_tokens, pointer)
        outputs = {"pred_masks": low_res, "high_res_masks": high_res, "object_pointer": pointer,
                   "object_score_logits": obj_logits, "iou_scores": iou}
        return state, outputs
