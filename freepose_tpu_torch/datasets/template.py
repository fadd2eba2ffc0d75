"""Webdataset-style template shards: writer + streaming reader with prefetch.

Byte-compatible with the reference's template shards
(scripts/render_templates.py:49-72 writes `shard-%06d.tar` with 10 meshes ×
600 views of `{mesh}_{k}.rgb.png` uint8 + `{mesh}_{k}.depth.png` uint16 mm;
reader at src/dataloader/template.py:26-99, member-index .npy memo at
:57-61). The reader adds a background-thread prefetcher so tar decode
overlaps with device compute (the reference decodes synchronously in the
inference loop).
"""
from __future__ import annotations

import io
import queue
import tarfile
import threading
from pathlib import Path

import numpy as np

MESHES_PER_SHARD = 10
VIEWS_PER_MESH = 600


def _png_bytes(arr: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def write_shard(
    path: str | Path,
    meshes: dict,  # name -> (rgb [V, H, W, 3] float/uint8, depth [V, H, W] metres)
) -> None:
    with tarfile.open(Path(path), "w") as tar:
        for name, (rgb, depth) in meshes.items():
            clean = name.replace("_", "")
            for k in range(rgb.shape[0]):
                img = rgb[k]
                if img.dtype != np.uint8:
                    img = np.clip(np.asarray(img) * 255, 0, 255).astype(np.uint8)
                d16 = np.clip(np.asarray(depth[k]) * 1000.0, 0, 65535).astype(np.uint16)
                for suffix, payload in ((f"{clean}_{k}.rgb.png", _png_bytes(img)),
                                        (f"{clean}_{k}.depth.png", _png_bytes(d16))):
                    info = tarfile.TarInfo(suffix)
                    info.size = len(payload)
                    tar.addfile(info, io.BytesIO(payload))


class WebTemplateDataset:
    """Streams per-mesh template packs out of tar shards.

    filelist: ordered mesh names (the reference's mesh_cache.txt order, which
    also defines feature-bank row order).
    """

    def __init__(self, wds_dir: str | Path, filelist: list[str], views: int | None = None):
        import os

        self.dir = Path(wds_dir)
        self.names = [n.replace("_", "") for n in filelist]
        if views is None:
            views = int(os.environ.get("FREEPOSE_TEMPLATE_VIEWS", VIEWS_PER_MESH))
        self.views = views

    def __len__(self) -> int:
        return len(self.names)

    def index_of(self, model_name: str) -> int:
        return self.names.index(model_name.replace("_", ""))

    def _member_index(self, tar_path: Path, tar: tarfile.TarFile) -> dict:
        memo = tar_path.with_suffix(".index.npy")
        if memo.exists():
            return np.load(memo, allow_pickle=True).item()
        idx = {m.name: (m.offset_data, m.size) for m in tar.getmembers()}
        try:
            np.save(memo, idx, allow_pickle=True)
        except OSError:
            pass
        return idx

    def __getitem__(self, idx: int) -> dict:
        from PIL import Image

        shard = idx // MESHES_PER_SHARD
        tar_path = self.dir / f"shard-{shard:06d}.tar"
        name = self.names[idx]
        rgbs, depths = [], []
        with tarfile.open(tar_path) as tar:
            index = self._member_index(tar_path, tar)
            raw = tar.fileobj
            for k in range(self.views):
                off, size = index[f"{name}_{k}.rgb.png"]
                raw.seek(off)
                rgbs.append(np.asarray(Image.open(io.BytesIO(raw.read(size))).convert("RGB")))
                off, size = index[f"{name}_{k}.depth.png"]
                raw.seek(off)
                depths.append(np.asarray(Image.open(io.BytesIO(raw.read(size)))))
        rgb = np.stack(rgbs).astype(np.float32) / 255.0
        depth = np.stack(depths).astype(np.float32) / 1000.0
        masks = depth > 0
        # Degenerate-mask fallback (reference src/dataloader/template.py:75-77):
        # a view whose mask has <100 pixels gets a central half-size square
        # (105:315 at the 420² template resolution) so downstream crops and
        # mask-pooled features stay well-defined.
        bad = masks.sum(axis=(1, 2)) < 100
        if bad.any():
            h, w = masks.shape[1:]
            masks[bad, h // 4 : 3 * h // 4, w // 4 : 3 * w // 4] = True
        return {
            "model_name": name,
            "rgb": rgb,
            "depth": depth,
            "masks": masks,
            "intrinsic": np.array([[600.0, 0, 210], [0, 600, 210], [0, 0, 1]], np.float32),
        }

    def get_template_by_name(self, model_name: str) -> dict:
        return self[self.index_of(model_name)]


class Prefetcher:
    """Background-thread item prefetcher (the reference's async frame loader
    pattern, sam2/utils/misc.py:104-160, applied to any indexable dataset)."""

    def __init__(self, dataset, indices, depth: int = 2):
        self.dataset = dataset
        self.queue: queue.Queue = queue.Queue(maxsize=depth)
        self.indices = list(indices)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for i in self.indices:
                self.queue.put(("ok", self.dataset[i]))
        except Exception as e:  # surface errors on the consumer side
            self.queue.put(("err", e))
        self.queue.put(("end", None))

    def __iter__(self):
        while True:
            kind, item = self.queue.get()
            if kind == "err":
                raise item
            if kind == "end":
                return
            yield item
