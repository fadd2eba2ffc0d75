"""Device mesh and sharding helpers.

Counterpart of freepose_tpu.parallel.mesh. The JAX package's mesh is a
single-controller `jax.sharding.Mesh`: one process drives every device of
a ("data", "model") grid, and `shard_map` runs one block of the work on
each. Here the mesh is the same grid of `torch.device`s inside one process:
each shard's work is launched on its own device, and its outputs are
copied to the mesh's first device, where the epilogues run. A cross-device
copy orders itself on both devices' current streams, so a sharded step
needs no `torch.cuda.synchronize()`.

One host thread issues every shard's launches in turn, so a sharded step
is bound by the host: on four H100s of one host refine_sharded took longer
per frame than refine() on one card, and the sharded top-k longer than
the whole-bank search. Until the shards get launch threads or CUDA graphs
of their own, sharding adds time. SAM2's object shards and the sharded
smooth pass have not been timed across cards.

  * axis "data": frames, intervals and SAM2 objects fan out;
  * axis "model": the retrieval bank's rows and the refine neighbourhood.

A shard along one axis runs on the first device of the other axis (JAX
would compute the same block once per device of that axis). Unlike JAX's
`Mesh`, a device list may repeat a device: the tests build a 2 x 4 mesh on
the one `cpu` device, and a single card can hold several shards.

`torch.distributed` carries only the rendezvous that gives the work
scheduler (parallel/scheduler.py) its rank and world size; no collective
crosses processes, as in the JAX package.
"""
from __future__ import annotations

import copy
import dataclasses
import math
import os

import numpy as np
import torch
from torch import nn

AXES = ("data", "model")


def maybe_initialize_distributed() -> None:
    """Join the process group that FREEPOSE_COORDINATOR (host:port),
    FREEPOSE_NUM_PROCESSES and FREEPOSE_PROCESS_ID describe (gloo over
    TCP). Without FREEPOSE_COORDINATOR, or when a group is already
    initialised, it does nothing."""
    import torch.distributed as dist

    coordinator = os.environ.get("FREEPOSE_COORDINATOR")
    if not coordinator or dist.is_initialized():
        return
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=int(os.environ.get("FREEPOSE_NUM_PROCESSES", "1")),
        rank=int(os.environ.get("FREEPOSE_PROCESS_ID", "0")),
    )


def canonical_device(device) -> torch.device:
    """torch.device with the CUDA index filled in ("cuda" -> the current
    card), so devices compare equal however they were named."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(eq=False)
class DeviceMesh:
    """A [data, model] grid of devices. `shape` maps each axis name to its
    size, as JAX's `mesh.shape` does; `first` is grid[0][0], where outputs
    are gathered and epilogues run."""

    grid: list  # [data][model] torch.device
    axis_names: tuple = AXES

    def __post_init__(self):
        self._replicas: dict = {}

    @property
    def shape(self) -> dict:
        return {"data": len(self.grid), "model": len(self.grid[0])}

    @property
    def first(self) -> torch.device:
        return self.grid[0][0]

    @property
    def devices(self) -> list:
        """Every device of the grid, row by row (repeats kept)."""
        return [d for row in self.grid for d in row]

    @property
    def distinct_devices(self) -> list:
        """The grid's devices, each once, in order of first appearance."""
        return list(dict.fromkeys(self.devices))

    def axis_devices(self, axis: str) -> list:
        """The device of each shard along `axis`: the first row or column of
        the grid."""
        if axis == "data":
            return [row[0] for row in self.grid]
        if axis == "model":
            return list(self.grid[0])
        raise ValueError(f"unknown mesh axis {axis!r} (axes: {self.axis_names})")


def make_mesh(data: int | None = None, model: int | None = None, devices=None) -> DeviceMesh:
    """A (data, model) mesh over `devices` (default: every CUDA card, which
    raises without one). Sizes default as in the JAX package: all devices
    on "model", or the missing size from the device count. An explicit
    device list may repeat a device."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh() with no device list needs a CUDA device; pass devices=[...]")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [canonical_device(d) for d in devices]
    n = len(devices)
    if data is None and model is None:
        data, model = 1, n
    elif data is None:
        data = n // model
    elif model is None:
        model = n // data
    if data * model != n or n == 0:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return DeviceMesh([devices[i * model:(i + 1) * model] for i in range(data)])


def cards_mesh(device, axis: str) -> DeviceMesh:
    """The shard flags' mesh: every card on `axis` (the other axis of size
    1), `device` first, where the caller's models and outputs live; a CPU
    device alone."""
    dev = canonical_device(device)
    if dev.type != "cuda":
        return make_mesh(devices=[dev])
    cards = [dev] + [d for d in (torch.device("cuda", i) for i in range(torch.cuda.device_count())) if d != dev]
    return make_mesh(data=len(cards), devices=cards) if axis == "data" else make_mesh(model=len(cards), devices=cards)


def pad_bank_rows(bank, mesh: DeviceMesh):
    """Zero-pad bank rows to a multiple of the "model" axis size (real banks,
    e.g. the 46,037-mesh Objaverse+GSO bank, do not divide evenly)."""
    pad = (-bank.shape[0]) % mesh.shape["model"]
    if not pad:
        return bank
    if torch.is_tensor(bank):
        return torch.cat([bank, bank.new_zeros((pad,) + tuple(bank.shape[1:]))])
    bank = np.asarray(bank)
    return np.concatenate([bank, np.zeros((pad,) + bank.shape[1:], bank.dtype)])


class BankShards(list):
    """shard_bank's row blocks, one per "model" shard, with `n_rows`, the
    bank's rows before padding: ops/knn.py:topk_search_sharded keeps the
    padding rows out of the top-k by it."""

    def __init__(self, blocks, n_rows: int):
        super().__init__(blocks)
        self.n_rows = n_rows


def shard_bank(bank, mesh: DeviceMesh) -> BankShards:
    """A [M, D] bank as one row block per "model" shard, each on its device
    (rows padded to a multiple of the axis: pad_bank_rows)."""
    return BankShards(split(torch.as_tensor(pad_bank_rows(bank, mesh)), mesh, "model"), bank.shape[0])


def shard_batch(x, mesh: DeviceMesh) -> list:
    """A leading batch axis split over "data", one block per shard."""
    return split(torch.as_tensor(x), mesh, "data")


def split(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> list:
    """x's leading axis in mesh.shape[axis] equal blocks, block j on the
    device of shard j along `axis` (shard_map's in_specs P(axis))."""
    devs = mesh.axis_devices(axis)
    if x.shape[0] % len(devs):
        raise ValueError(f"leading axis {x.shape[0]} must divide over the '{axis}' axis ({len(devs)} devices)")
    return [part.to(d, non_blocking=True) for part, d in zip(torch.chunk(x, len(devs)), devs)]


def gather(parts: list, mesh: DeviceMesh):
    """The shards' outputs concatenated on mesh.first along the leading
    axis (shard_map's out_specs P(axis)). `parts` holds one tensor per
    shard, or one tuple of tensors per shard (then a tuple comes back)."""
    if isinstance(parts[0], (tuple, list)):
        return tuple(gather([p[i] for p in parts], mesh) for i in range(len(parts[0])))
    return torch.cat([p.to(mesh.first, non_blocking=True) for p in parts])


def _replica(x, device: torch.device):
    if torch.is_tensor(x):
        return x.to(device)
    if isinstance(x, (tuple, list)):
        return type(x)(_replica(a, device) for a in x)
    if isinstance(x, nn.Module):
        p = next(x.parameters(), None)
        if p is not None and p.device == device:
            return x
        return copy.deepcopy(x).to(device)
    if hasattr(x, "replica"):
        return x.replica(device)
    raise TypeError(f"cannot replicate a {type(x).__name__}")


def replicate(x, mesh: DeviceMesh) -> dict:
    """One copy of `x` per distinct device of the mesh, as {device: copy}
    (shard_map's in_specs P()); a repeated device shares one copy.
    Tensors, and tuples and lists of them, are copied with `.to` on each
    call. An nn.Module is deep-copied to each device it is not already on,
    and an object with a `replica(device)` method (DinoFeatureExtractor)
    makes its own; these copies are cached on the mesh for its life."""
    if torch.is_tensor(x) or isinstance(x, (tuple, list)):
        return {d: _replica(x, d) for d in mesh.distinct_devices}
    entry = mesh._replicas.get(id(x))
    if entry is None or entry[0] is not x:  # the entry holds x, so its id is not reused while cached
        entry = mesh._replicas[id(x)] = (x, {d: _replica(x, d) for d in mesh.distinct_devices})
    return entry[1]


def pad_to_multiple(n: int, *multiples: int) -> int:
    """n rounded up to a multiple of lcm(multiples)."""
    m = math.lcm(*multiples)
    return -(-n // m) * m
