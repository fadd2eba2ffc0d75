"""Model configurations from a configuration file of `configs/`, built as
the dataclasses of a module namespace: the port's (the system under test)
or the reference's frozen copies, whose fields are the same."""
from __future__ import annotations

import dataclasses
import importlib

import torch

PORT = "freepose_tpu_torch"
FROZEN = "benchmark.reference.frozen"
_PATHS = {"sam2.hiera": "models.sam2.hiera", "sam2.prompt": "models.sam2.prompt",
          "sam2.mask_decoder": "models.sam2.mask_decoder", "sam2.memory": "models.sam2.memory",
          "sam2.model": "models.sam2.model", "sam2.video": "models.sam2.video", "dinov2": "models.dinov2"}


def _module(package: str, name: str):
    return importlib.import_module(f"{package}.{_PATHS[name] if package == PORT else name}")


def _fields(cls, values: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: tuple(v) if isinstance(v, list) else v for k, v in values.items() if k in names}


def sam2_image_config(cfg: dict, package: str, dtype: torch.dtype, use_flash: bool):
    """The SAM2 image configuration of `cfg` (the configuration file's
    "sam2" group) in `package`'s dataclasses, every part at `dtype`, the
    trunk's global attention on its kernel where `use_flash`."""
    s = cfg["sam2"]
    hiera = _module(package, "sam2.hiera").HieraConfig(**_fields(
        _module(package, "sam2.hiera").HieraConfig, s["hiera"]), dtype=dtype, use_flash=use_flash)
    prompt = _module(package, "sam2.prompt").PromptConfig(**s["prompt"], dtype=dtype)
    decoder = _module(package, "sam2.mask_decoder").MaskDecoderConfig(**s["decoder"], dtype=dtype)
    return _module(package, "sam2.model").Sam2Config(hiera=hiera, prompt=prompt, decoder=decoder,
                                                      fpn_dim=s["fpn_dim"], dtype=dtype)


def sam2_video_config(cfg: dict, package: str, dtype: torch.dtype, use_flash: bool):
    """The SAM2 video configuration: the image configuration and the
    "memory" group, memory attention on its kernels where `use_flash`."""
    s = cfg["sam2"]
    mem_cls = _module(package, "sam2.memory").MemoryConfig
    mem = mem_cls(**_fields(mem_cls, s["memory"]), dtype=dtype, use_flash=use_flash)
    return _module(package, "sam2.video").Sam2VideoConfig(sam=sam2_image_config(cfg, package, dtype, use_flash),
                                                          mem=mem, image_size=s["image_size"],
                                                          mem_grid=s["mem_grid"])


def dinov2_config(cfg: dict, key: str, package: str, dtype: torch.dtype):
    """The DINOv2 configuration cfg[key] ("dinov2_l", "dinov2_b")."""
    cls = _module(package, "dinov2").DinoV2Config
    return cls(**_fields(cls, cfg[key]), dtype=dtype)


def served_dtype(cfg: dict) -> torch.dtype:
    return getattr(torch, cfg["dtype"])
