"""The port's device mesh (freepose_tpu_torch/parallel/mesh.py) against the
JAX package's, on the CPU.

JAX runs on conftest's 8 virtual CPU devices; the port's mesh repeats the
one `cpu` device 8 times, so every shard runs its own block of the work
in turn, exactly as on several cards. Same seeded numpy inputs and
weights (dinov2_from_jax) through both.

Tolerances: top-k indices identical and scores within 1e-5; sharded
features within 1e-5 of JAX's and of the port's unsharded extraction.
"""
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freepose_tpu.ops import knn as jknn
from freepose_tpu.parallel import mesh as jmesh
from freepose_tpu_torch.ops.knn import topk_search, topk_search_sharded
from freepose_tpu_torch.parallel import mesh as pmesh
from freepose_tpu_torch.parallel.scheduler import WorkShard, current_shard

REPO = Path(__file__).resolve().parent.parent
CPU8 = ["cpu"] * 8


def _norm(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_make_mesh_shapes_and_defaults():
    m = pmesh.make_mesh(devices=CPU8)
    assert m.shape == {"data": 1, "model": 8} == dict(jmesh.make_mesh().shape)
    m = pmesh.make_mesh(data=2, devices=CPU8)
    assert m.shape == {"data": 2, "model": 4} == dict(jmesh.make_mesh(data=2).shape)
    m = pmesh.make_mesh(model=2, devices=CPU8)
    assert m.shape == {"data": 4, "model": 2}
    assert m.axis_names == ("data", "model") == tuple(jmesh.make_mesh(4, 2).axis_names)
    assert m.first == torch.device("cpu") and m.distinct_devices == [torch.device("cpu")]
    assert len(m.devices) == 8 and len(m.axis_devices("data")) == 4 and len(m.axis_devices("model")) == 2
    with pytest.raises(ValueError, match="3x3 != 8"):
        pmesh.make_mesh(3, 3, devices=CPU8)
    with pytest.raises(ValueError, match="unknown mesh axis"):
        m.axis_devices("batch")


def test_make_mesh_without_devices_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        pmesh.make_mesh()


@pytest.mark.parametrize("rows", [16, 13])
def test_pad_shard_and_split_round_trip(rows):
    mesh = pmesh.make_mesh(data=2, devices=CPU8)  # model 4
    bank = np.arange(rows * 3, dtype=np.float32).reshape(rows, 3)
    padded = pmesh.pad_bank_rows(bank, mesh)
    np.testing.assert_array_equal(padded, np.asarray(jmesh.pad_bank_rows(bank, jmesh.make_mesh(2, 4))))
    np.testing.assert_array_equal(pmesh.pad_bank_rows(torch.as_tensor(bank), mesh).numpy(), padded)
    shards = pmesh.shard_bank(bank, mesh)
    assert len(shards) == 4 and all(s.shape == (len(padded) // 4, 3) for s in shards)
    np.testing.assert_array_equal(pmesh.gather(shards, mesh).numpy(), padded)
    batch = pmesh.shard_batch(padded[:12], mesh)
    assert len(batch) == 2
    np.testing.assert_array_equal(torch.cat(batch).numpy(), padded[:12])
    parts = [(torch.full((2,), j), torch.full((2, 1), -j)) for j in range(4)]
    a, b = pmesh.gather(parts, mesh)
    assert a.tolist() == [0, 0, 1, 1, 2, 2, 3, 3] and b[:, 0].tolist() == [0, 0, -1, -1, -2, -2, -3, -3]
    with pytest.raises(ValueError, match="must divide over the 'data' axis"):
        pmesh.split(torch.zeros(3), mesh, "data")


def test_replicate_shares_one_copy_per_distinct_device():
    from freepose_tpu_torch.models.dinov2 import VIT_TEST, DinoFeatureExtractor

    mesh = pmesh.make_mesh(data=2, devices=CPU8)
    fe = DinoFeatureExtractor(VIT_TEST, device="cpu")
    reps = pmesh.replicate(fe, mesh)
    assert list(reps) == [torch.device("cpu")] and reps[torch.device("cpu")] is fe
    assert pmesh.replicate(fe, mesh) is reps  # cached on the mesh
    lin = torch.nn.Linear(2, 2)
    assert pmesh.replicate(lin, mesh)[torch.device("cpu")] is lin
    x = torch.arange(4.0)
    tup = (x, x + 1)
    got = pmesh.replicate(tup, mesh)[torch.device("cpu")]
    assert got[0] is x and got[1] is tup[1]
    assert not mesh._replicas.get(id(tup))  # tensors are copied per call, not cached
    with pytest.raises(TypeError, match="cannot replicate"):
        pmesh.replicate(object(), mesh)
    # On another device a module is deep-copied there (the meta device
    # stands in for a second card).
    meta = pmesh.make_mesh(devices=["cpu", "meta"])
    copies = pmesh.replicate(lin, meta)
    assert copies[torch.device("cpu")] is lin and copies[torch.device("meta")].weight.device.type == "meta"


@pytest.mark.parametrize("n_rows", [1024, 1021], ids=["even", "uneven"])
def test_topk_search_sharded_matches_jax(n_rows):
    """1021 is prime: the bank pads to a multiple of the 8 shards."""
    rng = np.random.default_rng(9)
    bank = _norm(rng.normal(size=(n_rows, 32))).astype(np.float32)
    q = _norm(rng.normal(size=(6, 32))).astype(np.float32)
    jm = jmesh.make_mesh(1, 8)
    js, ji = jknn.topk_search_sharded(jmesh.shard_bank(jnp.asarray(bank), jm), jnp.asarray(q), 11, jm)
    mesh = pmesh.make_mesh(1, 8, devices=CPU8)
    shards = pmesh.shard_bank(bank, mesh)
    s, i = topk_search_sharded(shards, torch.as_tensor(q), 11, mesh)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-5)
    s1, i1 = topk_search(torch.as_tensor(bank), torch.as_tensor(q), 11)
    np.testing.assert_array_equal(i.numpy(), i1.numpy())
    np.testing.assert_allclose(s.numpy(), s1.numpy(), atol=1e-5)
    assert shards.n_rows == n_rows  # the bank's rows before padding


def test_topk_search_sharded_ties_and_padding():
    """Equal rows in different shards go to the lowest index, as
    topk_search orders them; with every score negative the zero padding
    rows would win if they were scored, and they never enter."""
    rng = np.random.default_rng(3)
    base = _norm(rng.normal(size=(5, 16))).astype(np.float32)
    bank = np.concatenate([base, base, base[:3]])  # 13 rows: pads to 16 over 4 shards
    mesh = pmesh.make_mesh(devices=["cpu"] * 4)
    shards = pmesh.shard_bank(bank, mesh)
    q = torch.as_tensor(base[[1, 4]])
    s, i = topk_search_sharded(shards, q, 4, mesh)
    s1, i1 = topk_search(torch.as_tensor(bank), q, 4)
    np.testing.assert_array_equal(i.numpy(), i1.numpy())
    assert i[0, :3].tolist() == [1, 6, 11]
    # A bank in the positive orthant against a query in the negative one.
    far = _norm(np.abs(rng.normal(size=(13, 16)))).astype(np.float32)
    far_shards = pmesh.shard_bank(far, mesh)
    q_neg = -torch.as_tensor(_norm(np.abs(rng.normal(size=(1, 16)))).astype(np.float32))
    assert (pmesh.gather(far_shards, mesh)[13:] @ q_neg.T == 0).all()  # a scored padding row would win
    s_real, i_real = topk_search_sharded(far_shards, q_neg, 3, mesh)
    s_ref, i_ref = topk_search(torch.as_tensor(far), q_neg, 3)
    np.testing.assert_array_equal(i_real.numpy(), i_ref.numpy())
    np.testing.assert_allclose(s_real.numpy(), s_ref.numpy(), atol=1e-5)
    assert (s_ref < 0).all()


@pytest.mark.parametrize("n", [8, 5], ids=["even", "uneven"])
def test_extract_sharded_matches_jax_and_single(n):
    from freepose_tpu.models.dinov2 import VIT_TEST as JAX_VIT_TEST
    from freepose_tpu.models.dinov2 import DinoFeatureExtractor as JaxExtractor
    from freepose_tpu_torch.models.dinov2 import VIT_TEST, DinoFeatureExtractor
    from tests.test_torch_online_estimator import vit_test_params

    params = vit_test_params()
    jfe = JaxExtractor(JAX_VIT_TEST, params=params)
    fe = DinoFeatureExtractor(VIT_TEST, params=params, device="cpu")
    imgs = np.random.default_rng(0).random((n, 3, 56, 56)).astype(np.float32)
    ref = np.asarray(jfe.extract_sharded(jnp.asarray(imgs), layer=2, feature_type="patch"))
    mesh = pmesh.make_mesh(data=8, devices=CPU8)
    got = fe.extract_sharded(torch.as_tensor(imgs), layer=2, feature_type="patch", mesh=mesh)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), fe(torch.as_tensor(imgs), layer=2).numpy(), atol=1e-5)


def test_current_shard_env_branches(monkeypatch):
    for var in ("FREEPOSE_SHARD_INDEX", "FREEPOSE_SHARD_COUNT", "SLURM_ARRAY_TASK_ID", "SLURM_ARRAY_TASK_COUNT"):
        monkeypatch.delenv(var, raising=False)
    assert current_shard() == WorkShard(0, 1)
    assert current_shard(2, 5) == WorkShard(2, 5)
    monkeypatch.setenv("SLURM_ARRAY_TASK_ID", "3")
    monkeypatch.setenv("SLURM_ARRAY_TASK_COUNT", "4")
    assert current_shard() == WorkShard(3, 4)
    monkeypatch.setenv("FREEPOSE_SHARD_INDEX", "1")
    monkeypatch.setenv("FREEPOSE_SHARD_COUNT", "2")
    assert current_shard() == WorkShard(1, 2)  # FREEPOSE_* before SLURM


def test_maybe_initialize_distributed_is_a_no_op_without_coordinator(monkeypatch):
    import torch.distributed as dist

    monkeypatch.delenv("FREEPOSE_COORDINATOR", raising=False)
    pmesh.maybe_initialize_distributed()
    assert not dist.is_initialized()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


WORKER = textwrap.dedent(
    """
    import json, os, sys
    import torch.distributed as dist
    from freepose_tpu_torch.parallel.mesh import maybe_initialize_distributed
    from freepose_tpu_torch.parallel.scheduler import current_shard, shard_items

    maybe_initialize_distributed()
    maybe_initialize_distributed()  # a second call is a no-op
    # The rendezvous is the proof: the world size reads 2 only once both
    # processes joined the group.
    assert dist.get_world_size() == 2, dist.get_world_size()
    shard = current_shard()
    assert shard.count == 2 and shard.index == dist.get_rank(), shard
    out = sys.argv[1]
    for i in shard_items(list(range(7)), shard):
        path = os.path.join(out, f"item_{i:02d}.json")
        if not os.path.exists(path):
            with open(path, "w") as f:
                json.dump({"item": i, "writer": shard.index}, f)
    dist.barrier()
    dist.destroy_process_group()
    """
)


def test_two_process_gloo_scheduler(tmp_path):
    """Two processes join one gloo group through the FREEPOSE_* variables;
    current_shard takes each one's rank and the world size, and the strided
    split covers every item once. Each process has 60 s."""
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    out = tmp_path / "out"
    out.mkdir()
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith(("SLURM_", "FREEPOSE_"))}
    env["PYTHONPATH"] = str(REPO)
    procs = [
        subprocess.Popen([sys.executable, str(script), str(out)],
                         env=env | {"FREEPOSE_COORDINATOR": f"127.0.0.1:{port}", "FREEPOSE_NUM_PROCESSES": "2",
                                    "FREEPOSE_PROCESS_ID": str(pid)},
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(2)
    ]
    try:
        outs = [p.communicate(timeout=60)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=10)
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o
    import json

    writers = {json.loads(f.read_text())["item"]: json.loads(f.read_text())["writer"]
               for f in sorted(out.glob("item_*.json"))}
    assert writers == {i: i % 2 for i in range(7)}
