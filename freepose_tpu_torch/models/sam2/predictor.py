"""SAM2 predictors: image (set_image / predict) and video (init, prompt,
propagate).

Counterpart of freepose_tpu.models.sam2.predictor's Sam2ImagePredictor and
Sam2VideoPredictor: the same calls and the same outputs. The image predictor
embeds an image once and decodes every prompt set against the cached
pyramid; all boxes of an image decode as one batched prompt set. The JAX
predictor bit-packs binary masks on the device to cut the host transfer;
here bool masks come back directly (the same masks). Tracing sees an image
as `sam2.image.embed` (set_image) and `sam2.image.predict` (the decode, the
resize and the fetch, which waits in `wait.sam2.image_masks`), and counts
`sam2.images`.

On a card, under inference mode, the image predictor replays two CUDA
graphs (utils/cuda_graphs.py; a key's first call runs eagerly, its second
captures, later calls replay), the same kernels in the eager order:
`_TrunkGraph`, the image trunk (Hiera, the neck, the skip projections and
the no-memory embedding) over a static [1, 3, S, S] input, so every image
size shares one graph and the pyramid the predictor holds is its static
output, valid until the next `set_image`; and `_DecodeGraph`, the prompt
encoder and the mask decoder over a prompt set padded to the next multiple
of PROMPT_BUCKET rows by repeating its last prompt (the decoder treats
prompts independently, so the first P rows are those of the P prompts), so
1 to 16 prompts share one graph. The upload, resize and normalisation before
the trunk stay eager, as do the two seams a caller may replace on the
instance: `_scale_prompts` (the prompts in model coordinates, before any
copy into the graph) and `_decode` (which `predict` calls). The counters
`sam2.image.graph_captures` and `sam2.image.graph_replays` count them; the
automatic mask generator shares the trunk graph and decodes eagerly. The CPU
runs everything eagerly, the prompts unpadded.

For video, objects are
grouped by (prompt frame, prompt kind); each group's state is stepped once
per frame with all its objects batched. Propagation follows the JAX batch
plan (`batch_plan`): a prompt frame alone, then runs of up to `chunk`
prompt-free frames. A batch's frames reach the card in one upload, or are
sliced from a video staged there (datasets/video.py:StagedVideo), and its
masks come back in one copy. The image trunk (Hiera and its neck) depends
on the frame alone, so it embeds all of a batch's frames in one call; the
memory, decoder and postprocess steps still run frame by frame, so a batch
differs from frame-at-a-time propagation only by the trunk's rounding at
another batch size. On a card a prompt-free tracking step replays CUDA
graphs (models/sam2/video.py:_TrackGraph), and each group's object indices
reach the device once per propagation, so a tracking frame makes no host
round trip.
`propagate_batched` keeps the batch's binarised masks and frames on the
device for the coupled video step (pipeline/proposals.py:
proposals_from_masks_video).

With a device mesh (parallel/mesh.py) each group's objects split over its
"data" axis: the group pads to a multiple of the axis with no-prompt dummy
objects (every point label -10, as the JAX predictor pads), each shard
steps its block of object states on its device with the model replicated
there, a batch's pyramids are computed once per distinct device, and the
masks are gathered on the mesh's first device, the dummies' dropped.
"""
from __future__ import annotations

import numpy as np
import torch

from freepose_tpu_torch.models.sam2.model import Sam2Config, Sam2ImageModel, sam2_normalize
from freepose_tpu_torch.models.sam2.video import Sam2VideoConfig, Sam2VideoModel, init_object_state
from freepose_tpu_torch.ops.sampling import resize_bilinear
from freepose_tpu_torch.utils import timing
from freepose_tpu_torch.utils.cuda_graphs import GraphCache, capture

PROMPT_BUCKET = 16  # a graphed decode pads its prompt set to a multiple of this many rows


def prepare_image(image: torch.Tensor, size: int) -> torch.Tensor:
    """[H, W, 3] or a batch [K, H, W, 3], uint8 or float -> [1 or K, 3, size,
    size] normalised."""
    img = image.float()
    if image.dtype == torch.uint8:
        img = img / 255.0
    img = img if img.ndim == 4 else img[None]
    return sam2_normalize(resize_bilinear(img.permute(0, 3, 1, 2), (size, size)))


def apply_non_overlapping_constraints(pred_masks: torch.Tensor) -> torch.Tensor:
    """Keep only the highest-scoring object per pixel; the others clamp to
    <= -10. Objects on the leading axis."""
    if pred_masks.shape[0] == 1:
        return pred_masks
    ids = torch.arange(pred_masks.shape[0], device=pred_masks.device).reshape(-1, *([1] * (pred_masks.ndim - 1)))
    keep = pred_masks.argmax(dim=0, keepdim=True) == ids
    return torch.where(keep, pred_masks, torch.clamp(pred_masks, max=-10.0))


def postprocess_video_masks(low: torch.Tensor, high: torch.Tensor, orig_hw: tuple[int, int], non_overlap: bool,
                            binarize: bool):
    """Resize high-res logits [N, S, S] to the original resolution, apply the
    optional cross-object suppression, and optionally threshold at 0."""
    high = resize_bilinear(high, orig_hw)
    if non_overlap and low.shape[0] > 1:
        low = apply_non_overlapping_constraints(low)
        high = apply_non_overlapping_constraints(high)
    if binarize:
        return low > 0, high > 0
    return low.float(), high


def scale_coords(coords: torch.Tensor, orig_hw: tuple[int, int], size: int) -> torch.Tensor:
    """Pixel coordinates (x, y) in the original image -> model input coordinates."""
    h, w = orig_hw
    return coords * torch.tensor([size / w, size / h], dtype=coords.dtype, device=coords.device)


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """`t` on `device`; a host tensor reaches a card through pinned memory
    without blocking the host (an upload from pageable memory waits for the
    work queued before it, such as the trunk)."""
    if device.type != "cuda" or t.device.type != "cpu":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def prompt_bucket(n: int) -> int:
    """The rows a graphed decode of `n` prompts runs: the next multiple of
    PROMPT_BUCKET at or above n."""
    return -(-n // PROMPT_BUCKET) * PROMPT_BUCKET


def pad_prompts(prompts, rows: int):
    """(points [1, P, N, 2], labels [1, P, N], boxes [1, P, 4]), each a
    tensor or None, padded on the prompt axis to `rows` by repeating the last
    prompt."""
    def pad(x):
        if x is None or x.shape[1] == rows:
            return x
        return torch.cat([x, x[:, -1:].expand(-1, rows - x.shape[1], *x.shape[2:])], dim=1)

    return tuple(pad(x) for x in prompts)


def trunk_graph_key(config: Sam2Config, device: torch.device, pixels: torch.Tensor):
    """The key of the CUDA graph that replays the image trunk on `pixels`
    (normalised, [1, 3, S, S]), or None (eager): the CPU, or outside
    inference mode. It holds what a replay depends on and a call can see: the
    input's shape and dtype, and the global blocks' attention function, so a
    swapped function never replays the former one."""
    if device.type != "cuda" or not torch.is_inference_mode_enabled():
        return None
    from freepose_tpu_torch.ops import attention

    return tuple(pixels.shape), pixels.dtype, attention.flash_attention_auto if config.hiera.use_flash else None


def decode_graph_key(device: torch.device, prompts, multimask: bool):
    """The key of the CUDA graph that decodes `prompts` (`_scale_prompts`'
    triple), or None (eager): the CPU, outside inference mode, or no prompt.
    It holds the padded row count, each prompt kind's presence, its shape
    past the prompt axis (the points a prompt) and dtype, and the multimask
    choice."""
    given = [p for p in prompts if p is not None]
    if device.type != "cuda" or not given or given[0].shape[1] == 0 or not torch.is_inference_mode_enabled():
        return None
    return (prompt_bucket(given[0].shape[1]), multimask,
            *(None if p is None else (tuple(p.shape[2:]), p.dtype) for p in prompts))


def _decode_masks(model: Sam2ImageModel, pyramid, prompts, multimask: bool):
    """-> (low-res logits [P, M, g, g], iou [P, M]) of the prompt triple."""
    points, labels, boxes = prompts
    masks, iou, _, _ = model.decode_masks(pyramid, points=points, labels=labels, boxes=boxes,
                                          multimask_output=multimask)
    return masks[0], iou[0]


class _TrunkGraph:
    """`embed_image` over a static input as one CUDA graph. A call copies
    its pixels in, replays, counts `sam2.image.graph_replays` and returns the
    static pyramid, which the next replay overwrites."""

    def __init__(self, model: Sam2ImageModel, pixels: torch.Tensor):
        self.pixels = pixels.clone()

        def embed():
            self.pyramid, _ = model.embed_image(self.pixels)

        self.graph, = capture(pixels.device, embed, embed)
        timing.count("sam2.image.graph_captures")

    def __call__(self, pixels: torch.Tensor) -> list[torch.Tensor]:
        self.pixels.copy_(pixels)
        self.graph.replay()
        timing.count("sam2.image.graph_replays")
        return self.pyramid


class _DecodeGraph:
    """The prompt encoder and the mask decoder over a static pyramid and a
    static padded prompt set as one CUDA graph. A call copies the pyramid
    and the padded prompts in, replays, counts `sam2.image.graph_replays`
    and returns copies of the first P rows."""

    def __init__(self, model: Sam2ImageModel, pyramid, prompts, multimask: bool):
        self.pyramid = [t.clone() for t in pyramid]
        self.prompts = [None if p is None else p.clone() for p in prompts]

        def decode():
            self.out = _decode_masks(model, self.pyramid, self.prompts, multimask)

        self.graph, = capture(pyramid[0].device, decode, decode)
        timing.count("sam2.image.graph_captures")

    def __call__(self, pyramid, prompts, n: int):
        for static, t in zip(self.pyramid, pyramid):
            static.copy_(t)
        for static, p in zip(self.prompts, prompts):
            if static is not None:
                static.copy_(p)
        self.graph.replay()
        timing.count("sam2.image.graph_replays")
        return tuple(o[:n].clone() for o in self.out)


class Sam2ImagePredictor:
    """Prompted masks on one image. params: the JAX package's Sam2ImageModel
    parameter tree (the "image" subtree of a video model's), converted by
    models/convert.py:state_dict_from_jax; None gives seeded random weights.
    Runs on `device` ("cuda" unless the caller asks for the CPU)."""

    def __init__(self, config: Sam2Config, params=None, image_size: int = 1024, device=None, seed: int = 0):
        from freepose_tpu_torch.device import resolve_device
        from freepose_tpu_torch.models.convert import random_sam2_image_params, state_dict_from_jax

        self.config = config
        self.device = resolve_device(device)
        self.image_size = image_size
        if params is None:
            params = random_sam2_image_params(config, seed=seed)
        model = Sam2ImageModel(config)
        missing, unexpected = model.load_state_dict(state_dict_from_jax(params), strict=False)
        # The mask-prompt encoder comes along whenever the tree has it (a
        # converted checkpoint always does); a tree from the JAX model's own
        # init without a mask input lacks it, and only mask prompts (the
        # automatic generator's m2m) reach it.
        if unexpected or any(not k.startswith("prompt_encoder.mask_embed.") for k in missing):
            raise ValueError(f"SAM2 image parameters do not fit: missing {missing}, unexpected {unexpected}")
        self.has_mask_prompt_encoder = not missing
        self.model = model.to(self.device).eval()
        self._pyramid = None
        self._orig_hw = None
        # The graphs replay the model's parameter tensors of their capture:
        # weights are copied into them in place (load_state_dict) before use.
        self._trunk_graphs, self._decode_graphs = GraphCache(), GraphCache()

    @torch.inference_mode()
    def set_image(self, image) -> None:
        """image [H, W, 3] uint8 or float in [0, 1] (numpy or a tensor). On a
        card the trunk replays its key's graph (`_TrunkGraph`), and the
        pyramid is the graph's static output until the next call."""
        timing.count("sam2.images")
        with timing.span("sam2.image.embed"):
            image = _to_device(image if torch.is_tensor(image) else torch.from_numpy(np.ascontiguousarray(image)),
                               self.device)
            self._orig_hw = (int(image.shape[0]), int(image.shape[1]))
            pixels = prepare_image(image, self.image_size)
            key = trunk_graph_key(self.model.config, self.device, pixels)
            graph = None if key is None else self._trunk_graphs.get(key, lambda: _TrunkGraph(self.model, pixels))
            self._pyramid = self.model.embed_image(pixels)[0] if graph is None else graph(pixels)

    def _scale_prompts(self, point_coords, point_labels, box):
        """Prompts in original pixels -> (points [1, P, N, 2], labels
        [1, P, N], boxes [1, P, 4]) in model coordinates, or None each.
        Host prompts are scaled on the host and reach a card without
        blocking it (`_to_device`); device boxes are scaled there."""
        pts = labels = boxes = None
        dev, hw, size = self.device, self._orig_hw, self.image_size
        if point_coords is not None:
            pts = scale_coords(torch.as_tensor(np.asarray(point_coords), dtype=torch.float32), hw, size)
            pts = _to_device(pts.reshape(1, -1, pts.shape[-2] if pts.ndim > 2 else pts.shape[0], 2), dev)
            labels = _to_device(torch.as_tensor(np.asarray(point_labels)).long().reshape(1, pts.shape[1], -1), dev)
        if box is not None:
            b = box.float() if torch.is_tensor(box) else torch.as_tensor(np.asarray(box), dtype=torch.float32)
            boxes = _to_device(scale_coords(b.reshape(1, -1, 2, 2), hw, size).reshape(1, -1, 4), dev)
        return pts, labels, boxes

    @torch.inference_mode()
    def _decode(self, point_coords, point_labels, box, multimask_output: bool):
        """-> (low-res logits [P, M, g, g], iou [P, M]) on the device. On a
        card the prompt set pads to its bucket and replays its key's graph
        (`_DecodeGraph`); the key's first call runs the padded set eagerly."""
        if self._pyramid is None:
            raise RuntimeError("call set_image first")
        prompts = self._scale_prompts(point_coords, point_labels, box)
        key = decode_graph_key(self.device, prompts, multimask_output)
        if key is None:
            return _decode_masks(self.model, self._pyramid, prompts, multimask_output)
        n = next(p.shape[1] for p in prompts if p is not None)
        padded = pad_prompts(prompts, key[0])
        graph = self._decode_graphs.get(key, lambda: _DecodeGraph(self.model, self._pyramid, padded,
                                                                  multimask_output))
        if graph is None:
            masks, iou = _decode_masks(self.model, self._pyramid, padded, multimask_output)
            return masks[:n], iou[:n]
        return graph(self._pyramid, padded, n)

    def predict(self, point_coords=None, point_labels=None, box=None, multimask_output: bool = True,
                return_logits: bool = False, fetch_low_res_logits: bool = True):
        """Returns (masks [P, M, H, W] at the original resolution, iou
        [P, M], low-res logits [P, M, g, g]) as numpy arrays: bool masks
        (logits > 0), or float logits with return_logits; the low-res logits
        are None when fetch_low_res_logits is False."""
        with timing.span("sam2.image.predict"):
            logits, iou = self._decode(point_coords, point_labels, box, multimask_output)
            full = resize_bilinear(logits, self._orig_hw)
            full = full if return_logits else full > 0
            with timing.wait("sam2.image_masks"):
                low = logits.float().cpu().numpy() if fetch_low_res_logits else None
                return full.cpu().numpy(), iou.float().cpu().numpy(), low

    def predict_device(self, point_coords=None, point_labels=None, box=None, multimask_output: bool = True):
        """`predict` with device outputs: (bool masks [P, M, H, W] at the
        original resolution, iou [P, M]); box prompts may be device tensors
        (GroundingDinoDetector.detect_topk_device's boxes)."""
        logits, iou = self._decode(point_coords, point_labels, box, multimask_output)
        return resize_bilinear(logits, self._orig_hw) > 0, iou


class Sam2VideoPredictor:
    """Multi-object video tracker. params: the JAX package's parameter tree
    (nested dicts of numpy arrays), converted by
    models/convert.py:sam2_video_from_jax; None gives seeded random
    weights. Runs on `device` ("cuda" unless the caller asks for the CPU);
    with `device_mesh` on the mesh's first device, the objects split over
    its "data" axis."""

    def __init__(self, config: Sam2VideoConfig, params=None, max_objects: int = 8, device=None, seed: int = 0,
                 device_mesh=None):
        from freepose_tpu_torch.device import resolve_device
        from freepose_tpu_torch.models.convert import random_sam2_video_params, sam2_video_from_jax
        from freepose_tpu_torch.parallel.mesh import canonical_device, replicate

        self.config = config
        if device_mesh is not None and device is None:
            device = device_mesh.first
        self.device = resolve_device(device)
        if device_mesh is not None and canonical_device(self.device) != device_mesh.first:
            raise ValueError(f"device {self.device} is not the mesh's first device {device_mesh.first}")
        self.max_objects = max_objects
        if params is None:
            params = random_sam2_video_params(config, seed=seed)
        model = Sam2VideoModel(config)
        model.load_state_dict(sam2_video_from_jax(params))
        self.model = model.to(self.device).eval()
        # The device of each object shard, and the model on each device.
        self._shard_devices = device_mesh.axis_devices("data") if device_mesh is not None else [self.device]
        self._models = replicate(self.model, device_mesh) if device_mesh is not None else {self.device: self.model}

    def init_state(self, frames):
        """frames: [T, H, W, 3] uint8 or float on the host (each batch is
        uploaded once), or a StagedVideo (datasets/video.py) or a tensor on
        the device, sliced there with no upload."""
        from freepose_tpu_torch.datasets.video import StagedVideo

        t = frames.n if isinstance(frames, StagedVideo) else frames.shape[0]
        if isinstance(frames, StagedVideo):
            frames = frames.frames
        h, w = frames.shape[1], frames.shape[2]
        return {"frames": frames, "orig_hw": (h, w), "num_frames": t, "n_objects": 0, "obj_ids": [],
                "prompts": {}, "pyramid_cache": {}}

    def _frame_batch(self, state, ts: list[int]) -> torch.Tensor:
        """The frames of a batch of consecutive indices (ascending or
        descending) as [K, H, W, 3] on the device: a slice of a device
        video, or one upload of the host frames."""
        src = state["frames"]
        lo, hi = min(ts), max(ts) + 1
        if torch.is_tensor(src):
            batch = src[lo:hi].to(self.device)
        else:  # a host array or a lazy frame loader
            batch = torch.as_tensor(np.stack([np.asarray(src[t]) for t in range(lo, hi)])).to(self.device)
        return batch if ts[0] == lo else batch.flip(0)

    def _frame_pyramid(self, state, frame_idx: int):
        """The frame's (pyramid, pos) on the predictor's device."""
        return self._frame_pyramids(state, frame_idx)[self._shard_devices[0]]

    def _frame_pyramids(self, state, frame_idx: int) -> dict:
        """The frame's (pyramid, pos) on each device of the object shards,
        from the cache of the current batch's frames, else embedded alone."""
        if frame_idx not in state["pyramid_cache"]:
            self._embed_frames(state, [frame_idx])
        return state["pyramid_cache"][frame_idx]

    @torch.inference_mode()
    def _embed_frames(self, state, ts: list[int], frames: torch.Tensor | None = None) -> None:
        """Replace the pyramid cache by the frames `ts` ([K, H, W, 3] on the
        device, else uploaded): one trunk call over all K frames per distinct
        device of the object shards; frame t's entry holds its batch-of-one
        slice of each pyramid level and the shared sine positions."""
        cache = state["pyramid_cache"]
        cache.clear()
        if frames is None:
            frames = self._frame_batch(state, ts)
        embedded = {}
        with timing.span("sam2.trunk"):
            for d in dict.fromkeys(self._shard_devices):
                timing.count("sam2.trunk_calls")
                embedded[d] = self._models[d].embed_frame(prepare_image(frames.to(d), self.config.image_size))
        for z, t in enumerate(ts):
            cache[t] = {d: ([level[z:z + 1] for level in pyramid], pos) for d, (pyramid, pos) in embedded.items()}

    def _register(self, state, obj_id: int, prompt) -> None:
        # Re-prompting an existing object replaces its prompt: the next
        # propagation rebuilds every object's state from its prompt.
        if obj_id in state["obj_ids"]:
            idx = state["obj_ids"].index(obj_id)
        else:
            state["obj_ids"].append(obj_id)
            idx = len(state["obj_ids"]) - 1
        state["prompts"][idx] = prompt
        state["n_objects"] = len(state["obj_ids"])

    def add_new_points_or_box(self, state, frame_idx: int, obj_id: int, points=None, labels=None, box=None):
        """Register an object with its prompt; tracking starts at this
        frame. A box becomes 2 corner points labelled (2, 3)."""
        h, w = state["orig_hw"]
        size = self.config.image_size
        if box is not None:
            pts = np.asarray(box, np.float64).reshape(2, 2) * np.array([size / w, size / h])
            lbl = np.array([2, 3], np.int32)
        else:
            pts = np.asarray(points, np.float64).reshape(-1, 2) * np.array([size / w, size / h])
            lbl = np.asarray(labels, np.int32).reshape(-1)
        pad = self.config.max_point_prompts - pts.shape[0]
        pts = np.pad(pts, ((0, pad), (0, 0)))
        lbl = np.pad(lbl, (0, pad), constant_values=-10)  # -10 = padding points
        self._register(state, obj_id, (frame_idx, pts.astype(np.float32), lbl))
        return state

    def add_new_mask(self, state, frame_idx: int, obj_id: int, mask: np.ndarray):
        """Register an object with a binary mask prompt: the mask is resized
        to the model resolution (bilinear, then >= 0.5) and conditions the
        object's init step as its output."""
        mask = np.asarray(mask)
        self._register(state, obj_id, (frame_idx, None, None, mask if mask.dtype == bool else mask > 0))
        return state

    def propagate_batched(self, state, start_frame_idx: int = 0, max_frames: int | None = None,
                          reverse: bool = False, non_overlap_masks: bool = False, chunk: int = 8):
        """Propagation that stays on the device: yields (ts, lows [K, N, g4,
        g4] bool, highs [K, N, H, W] bool, frames [K, H, W, 3]) per batch,
        the masks binarised on the card and never fetched, with the batch's
        frames as they sit on the device (for proposals_from_masks_video)."""
        return self.propagate_in_video(state, start_frame_idx, max_frames, reverse, non_overlap_masks,
                                       binarize=True, chunk=chunk, device_batches=True)

    @torch.inference_mode()
    def propagate_in_video(self, state, start_frame_idx: int = 0, max_frames: int | None = None,
                           reverse: bool = False, non_overlap_masks: bool = False, binarize: bool = False,
                           chunk: int = 8, device_batches: bool = False):
        """Generator over frames -> (frame_idx, obj_ids, low-res masks
        [N, g4, g4], high-res masks [N, H, W] at the original resolution),
        as numpy arrays; bool masks (> 0) when binarize. reverse=True runs
        from the earliest prompt frame towards frame 0. Frames go in the
        batches of `batch_plan` (chunk=1: one frame each), each batch's
        masks fetched in one copy; device_batches yields whole batches on the
        device instead (`propagate_batched`) and needs binarize."""
        n = state["n_objects"]
        if n == 0:
            raise ValueError("no objects added")
        if device_batches and not binarize:
            raise ValueError("device_batches yields bool masks; set binarize=True")
        cfg = self.config
        dev = self.device
        num_frames = state["num_frames"]
        end = num_frames if max_frames is None else min(num_frames, start_frame_idx + max_frames)

        groups: dict[tuple[int, str], list[int]] = {}
        for i in range(n):
            p = state["prompts"][i]
            kind = "mask" if len(p) > 3 and p[3] is not None else "pts"
            groups.setdefault((p[0], kind), []).append(i)
        prompt_frame = min(k[0] for k in groups)
        # Each group's object indices on the device, made once: an upload
        # from pageable memory synchronises, so not on every frame.
        with timing.wait("sam2.group_index"):
            group_index = {key: torch.as_tensor(idxs, device=dev) for key, idxs in groups.items()}

        # Each group pads to a multiple of the shard count with dummy objects
        # (index None: no points, every label -10, or an empty mask), and
        # shard j steps the group's j-th block of objects on its device.
        shard_devs = self._shard_devices
        n_shards = len(shard_devs)

        def blocks(idxs):
            padded = list(idxs) + [None] * ((-len(idxs)) % n_shards)
            per = len(padded) // n_shards
            return [padded[j * per:(j + 1) * per] for j in range(n_shards)]

        def gather_outputs(outs, idxs):
            """The shards' low- and high-res logits on `dev`, dummies dropped."""
            return tuple(torch.cat([o[name].to(dev) for o in outs])[:len(idxs)]
                         for name in ("pred_masks", "high_res_masks"))

        def init_group(key, idxs, pyramids, t):
            states, outs = [], []
            for block, d in zip(blocks(idxs), shard_devs):
                st = init_object_state(cfg, len(block), device=d)
                (pyramid, pos), model = pyramids[d], self._models[d]
                if key[1] == "mask":
                    first_mask = np.asarray(state["prompts"][idxs[0]][3], np.float32)
                    ms = torch.as_tensor(np.stack([np.zeros_like(first_mask) if i is None else
                                                   np.asarray(state["prompts"][i][3], np.float32) for i in block]),
                                         device=d)
                    mk = (resize_bilinear(ms, (cfg.image_size, cfg.image_size)) >= 0.5).float()
                    st, out = model.track_step(st, pyramid, pyramid[2], pos[2], t, num_frames, mask_inputs=mk,
                                               is_init=True)
                else:
                    cap = cfg.max_point_prompts
                    pts = np.stack([np.zeros((cap, 2), np.float32) if i is None else state["prompts"][i][1]
                                    for i in block])
                    lbl = np.stack([np.full((cap,), -10, np.int32) if i is None else state["prompts"][i][2]
                                    for i in block])
                    with timing.wait("sam2.prompt"):  # uploads from pageable memory synchronise
                        pts, lbl = torch.as_tensor(pts, device=d), torch.as_tensor(lbl, device=d).long()
                    st, out = model.track_step(st, pyramid, pyramid[2], pos[2], t, num_frames,
                                               points=pts[:, None], labels=lbl[:, None], is_init=True)
                states.append(st)
                outs.append(out)
            return states, gather_outputs(outs, idxs)

        def step_group(key, pyramids, t):
            outs = []
            for j, d in enumerate(shard_devs):
                (pyramid, pos), st = pyramids[d], live[key][j]
                live[key][j], out = self._models[d].track_step(st, pyramid, pyramid[2], pos[2], t, num_frames,
                                                               reverse=reverse)
                outs.append(out)
            return gather_outputs(outs, groups[key])

        live: dict = {}
        if reverse:
            lo = -1 if max_frames is None else max(prompt_frame - max_frames, -1)
            order = range(prompt_frame, lo, -1)
            # Groups prompted after the sweep's start condition at their own
            # prompt frame first, so every object is tracked on every frame.
            for key in sorted(groups):
                if key[0] != prompt_frame:
                    live[key], _ = init_group(key, groups[key], self._frame_pyramids(state, key[0]), key[0])
        else:
            order = range(prompt_frame, end)

        def run_frame(t):
            pyramids = self._frame_pyramids(state, t)
            outs = []
            for key in sorted(groups):
                if key[0] == t and key not in live:
                    live[key], out = init_group(key, groups[key], pyramids, t)
                    outs.append((group_index[key], out))
            for key in sorted(live):
                if key[0] == t:
                    continue  # just initialised on this frame
                outs.append((group_index[key], step_group(key, pyramids, t)))
            with timing.span("sam2.postprocess"):
                l0, h0 = outs[0][1]
                low_raw = torch.full((n,) + l0.shape[1:], -32.0, dtype=l0.dtype, device=dev)
                high_raw = torch.full((n,) + h0.shape[1:], -32.0, dtype=h0.dtype, device=dev)
                for ii, (low, high) in outs:  # objects whose prompt frame has not come keep no-object logits
                    low_raw[ii] = low
                    high_raw[ii] = high
                return postprocess_video_masks(low_raw, high_raw, state["orig_hw"], non_overlap_masks, binarize)

        plan = batch_plan(list(order), {k[0] for k in groups}, {k[0] for k in live}, chunk)
        for ts in plan:
            # The batch's span closes before each yield: the consumer's work
            # between yields is not SAM2's.
            with timing.span("sam2.batch"):
                frames_b = self._frame_batch(state, ts)
                self._embed_frames(state, ts, frames_b)
                outs = [run_frame(t) for t in ts]
                lows, highs = torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])
                if not device_batches:
                    with timing.wait("sam2.masks"):
                        lows, highs = lows.cpu().numpy(), highs.cpu().numpy()
                timing.count("sam2.frames", len(ts))
            if device_batches:
                yield ts, lows, highs, frames_b
                continue
            for z, t in enumerate(ts):
                yield t, list(state["obj_ids"]), lows[z], highs[z]


def batch_plan(order: list[int], prompt_frames: set[int], live_frames: set[int], chunk: int) -> list[list[int]]:
    """The JAX predictor's batches over the sweep `order`: a frame whose
    group is still to be initialised alone (and every frame while no group
    is live, or with chunk 1), otherwise runs of up to `chunk` frames that
    stop before the next such prompt frame."""
    live_frames = set(live_frames)
    chunk = max(1, int(chunk))
    plan: list[list[int]] = []
    i = 0
    while i < len(order):
        t = order[i]
        if (t in prompt_frames and t not in live_frames) or chunk == 1 or not live_frames:
            plan.append([t])
            if t in prompt_frames:
                live_frames.add(t)
            i += 1
        else:
            j = i
            while j < len(order) and j - i < chunk and not (order[j] in prompt_frames and
                                                             order[j] not in live_frames):
                j += 1
            plan.append(order[i:j])
            i = j
    return plan
