"""Port parity: sharded checkpoints (``repro_torch.train.checkpoint``) and
the block arithmetic they rest on (``repro_torch.dist.sharding``'s
``spec_from_json``, ``shard_grid``, ``shard_coord``, ``assemble_shards``,
``assemble_region``) against the reference's.

The block helpers equal the reference's on its test shapes
(``tests/test_supervisor.py``), including "reads only the overlapping
blocks". Full and sharded saves round-trip bit for bit in fp32 and bf16;
garbled, truncated, sidecar-less and tampered checkpoints fall back as
``tests/test_elastic.py`` and ``tests/test_supervisor.py`` require, through
``tests/faults.py``; the reference's ``CheckpointManager.verify`` accepts a
checkpoint the port wrote and rejects it once tampered. Across ranks: a
sharded checkpoint written by 8 CPU ranks (fsdp_tp, after two adamw steps,
so the moments are not zero) restores onto 4 ranks under every strategy of
the registry, shard to shard, and every leaf gathered whole equals the
saved array bit for bit (one ``Pool`` of 8 for the module).
"""
import dataclasses
import os
import shutil
import sys

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from faults import corrupt_checkpoint, flaky, tamper_checkpoint
from repro.dist import sharding as JSH
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch.configs import TrainConfig, get_config, reduced
from repro_torch.dist import sharding as SH
from repro_torch.dist.pool import Pool
from repro_torch.dist.sharding import STRATEGIES
from repro_torch.train.checkpoint import ChecksumError, CheckpointManager
from repro_torch.train.supervisor import RetryPolicy, Supervisor

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_pool_jobs as jobs  # noqa: E402


def _toy_state(dtype=torch.float32):
    return {"p": torch.arange(6.0).reshape(2, 3).to(dtype), "step": 7,
            "w": torch.linspace(-3.0, 3.0, 64).to(dtype)}


def _same(a, b):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b)
    else:
        assert a == b


# ---------------------------------------------------------------------------
# The block arithmetic against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,grid", [((4, 6), (2, 2)), ((8,), (4,)),
                                        ((2, 3, 4), (2, 1, 2))])
def test_assemble_helpers_match_reference(shape, grid):
    arr = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    blk = tuple(s // g for s, g in zip(shape, grid))
    blocks = {}
    for coord in np.ndindex(*grid):
        sl = tuple(slice(c * b, (c + 1) * b) for c, b in zip(coord, blk))
        blocks[coord] = arr[sl]
        assert SH.shard_coord(sl, shape, grid) == JSH.shard_coord(sl, shape, grid) == coord
    np.testing.assert_array_equal(SH.assemble_shards(blocks, shape, grid), arr)
    np.testing.assert_array_equal(JSH.assemble_shards(blocks, shape, grid), arr)
    regions = [tuple(slice(None) for _ in shape), tuple(slice(1, s) for s in shape),
               tuple(slice(0, max(s // 2, 1)) for s in shape)]
    for region in regions:
        got = SH.assemble_region(blocks, shape, grid, region)
        np.testing.assert_array_equal(got, JSH.assemble_region(blocks, shape, grid, region))
        np.testing.assert_array_equal(got, arr[region])


def test_assemble_region_reads_only_overlapping_blocks():
    arr = np.arange(16.0).reshape(4, 4)
    touched = {"port": [], "ref": []}

    def lazy(who):
        class Lazy:
            def __getitem__(self, coord):
                touched[who].append(coord)
                i, j = coord
                return arr[i * 2:(i + 1) * 2, j * 2:(j + 1) * 2]
        return Lazy()

    region = (slice(0, 2), slice(0, 2))            # exactly block (0, 0)
    np.testing.assert_array_equal(SH.assemble_region(lazy("port"), (4, 4), (2, 2), region),
                                  arr[region])
    JSH.assemble_region(lazy("ref"), (4, 4), (2, 2), region)
    assert touched["port"] == touched["ref"] == [(0, 0)]


SPECS = [(), ("data",), (None, "model"), (("data", "model"),), ("model", "data"),
         (None, ("model", "data"))]
MESHES = [{"data": 8}, {"data": 4, "model": 2}, {"data": 2, "model": 4}]


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_shard_grid_and_spec_json_match_reference(mesh):
    for spec in SPECS:
        js = SH.spec_to_json(spec)
        assert SH.spec_from_json(js) == spec
        assert tuple(JSH.spec_from_json(js)) == tuple(P(*spec))
        for shape in [(16,), (16, 8), (6, 8), (8, 12)]:
            if len(spec) > len(shape):
                continue
            assert SH.shard_grid(spec, shape, mesh) == \
                JSH.shard_grid(P(*spec), shape, mesh), (spec, shape)


# ---------------------------------------------------------------------------
# Round trips, one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_full_and_sharded_roundtrip_bit_exact(tmp_path, dtype):
    state = _toy_state(dtype)
    cm = CheckpointManager(str(tmp_path / "full"), async_write=False)
    cm.save(1, state)
    got, step = cm.restore(state)
    assert step == 1 and cm.read_meta(1)["format"] == "full-v1"
    for k in state:
        _same(got[k], state[k])
    cs = CheckpointManager(str(tmp_path / "sharded"), async_write=False)
    specs = {"p": ("data", None), "step": (), "w": (("data", "model"),)}
    cs.save_sharded(2, state, mesh={"data": 2, "model": 2}, strategy="fsdp_tp",
                    specs=specs, extra_meta={"arch": "toy"})
    meta = cs.read_meta(2)
    assert meta["format"] == "sharded-v1" and meta["strategy"] == "fsdp_tp"
    assert meta["mesh"] == {"data": 2, "model": 2} and meta["arch"] == "toy"
    assert meta["specs"]["w"] == [["data", "model"]]
    assert sum(k.startswith("w@@") for k in meta["checksums"]) == 4
    got, step = cs.restore(state)
    assert step == 2 and cs.last_restore_mode == "host-assembly"
    for k in state:
        _same(got[k], state[k])


def test_gc_keep1_and_orphans(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=1, async_write=False)
    for s in (1, 2, 3):
        cm.save(s, _toy_state())
    assert sorted(os.listdir(tmp_path)) == ["ckpt_3.npz", "ckpt_3.npz.json"]
    cm.keep = 2
    with open(tmp_path / "ckpt_9.npz.json", "w") as f:
        f.write("{}")
    with open(tmp_path / ".tmp_ckpt_5.npz", "wb") as f:
        f.write(b"torn")
    cm.save(4, _toy_state())
    assert sorted(os.listdir(tmp_path)) == [
        "ckpt_3.npz", "ckpt_3.npz.json", "ckpt_4.npz", "ckpt_4.npz.json"]


@pytest.mark.parametrize("mode", ["garble", "truncate", "drop_sidecar", "tamper"])
def test_damaged_newest_falls_back(tmp_path, mode):
    cm = CheckpointManager(str(tmp_path), keep=5, async_write=False)
    state = _toy_state()
    cm.save(1, state)
    cm.save(2, {**state, "p": state["p"] * 9.0, "step": 9})
    if mode == "tamper":
        tamper_checkpoint(str(tmp_path), 2)
        assert not cm.verify(2)
    else:
        assert corrupt_checkpoint(str(tmp_path), mode=mode).endswith("ckpt_2.npz")
    if mode == "drop_sidecar":
        assert cm.available_steps() == [1]
    got, step = cm.restore(state)
    assert step == 1
    _same(got["p"], state["p"])


def test_async_save_equals_sync_and_wait_reraises(tmp_path):
    state = _toy_state()
    ca = CheckpointManager(str(tmp_path / "a"), async_write=True)
    ca.save(3, state)
    ca.wait()
    cs = CheckpointManager(str(tmp_path / "s"), async_write=False)
    cs.save(3, state)
    (ra, sa), (rs, ss) = ca.restore(state), cs.restore(state)
    assert sa == ss == 3
    for k in state:
        _same(ra[k], rs[k])
    cf = CheckpointManager(str(tmp_path / "f"),
                           fault_hook=lambda op, step: (_ for _ in ()).throw(OSError("x")))
    cf.save(1, state)
    with pytest.raises(OSError):
        cf.wait()
    cf.wait()                                     # consumed once
    assert issubclass(ChecksumError, ValueError)


def test_gc_never_deletes_last_verified_good(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=1, async_write=False)
    cm.save(1, _toy_state())
    cm.save(2, _toy_state())
    for suffix in (".npz", ".npz.json"):
        shutil.copy(str(tmp_path / f"ckpt_2{suffix}"), str(tmp_path / f"ckpt_3{suffix}"))
    tamper_checkpoint(str(tmp_path), 3)
    cm._gc()
    assert cm.available_steps() == [2] and cm.verify(2)


def test_supervised_flaky_write_and_fatal(tmp_path):
    fault = flaky(2, fn=lambda: None)
    cm = CheckpointManager(str(tmp_path / "a"), keep=3,
                           fault_hook=lambda op, step: fault())
    sup = Supervisor(policy=RetryPolicy(max_attempts=4, backoff_s=0.0),
                     sleep=lambda s: None)

    def write():
        cm.save(5, _toy_state())
        cm.wait()
    sup.run("checkpoint_save", write)
    assert sup.retries == 2 and cm.latest_step() == 5 and cm.verify(5)

    def bad_hook(op, step):
        raise ValueError("shape mismatch")
    cb = CheckpointManager(str(tmp_path / "b"), fault_hook=bad_hook)
    sup2 = Supervisor(policy=RetryPolicy(max_attempts=4, backoff_s=0.0),
                      sleep=lambda s: None)
    with pytest.raises(ValueError):
        sup2.run("checkpoint_save", lambda: (cb.save(5, _toy_state()), cb.wait()))
    assert sup2.retries == 0


@pytest.mark.parametrize("fmt", ["full", "sharded"])
def test_reference_verify_accepts_port_checkpoint(tmp_path, fmt):
    """The same CRC contract: the reference's manager verifies what the
    port wrote, and rejects it once an entry's bytes are flipped."""
    cm = CheckpointManager(str(tmp_path), async_write=False)
    state = _toy_state(torch.bfloat16)
    if fmt == "full":
        cm.save(4, state)
    else:
        cm.save_sharded(4, state, mesh={"data": 2}, strategy="fsdp",
                        specs={"p": ("data",), "step": (), "w": ("data",)})
    ref = JCheckpointManager(str(tmp_path), async_write=False)
    assert ref.available_steps() == [4] and ref.verify(4)
    tamper_checkpoint(str(tmp_path), 4)
    assert not JCheckpointManager(str(tmp_path), async_write=False).verify(4)
    assert not CheckpointManager(str(tmp_path), async_write=False).verify(4)


# ---------------------------------------------------------------------------
# Across ranks: 8 → 4 under every strategy
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pool():
    with Pool(world=8, device="cpu") as p:
        yield p


def test_sharded_8_ranks_restore_onto_4_every_strategy(pool, tmp_path):
    from repro_torch.data import make_batch_for
    cfg = dataclasses.replace(reduced(get_config("smollm-360m")), dtype="float32",
                              param_dtype="float32")
    tcfg = TrainConfig(optimizer="adamw", learning_rate=1e-3, total_steps=4,
                       warmup_steps=0, grad_compression="none")
    batch = {k: v.numpy() for k, v in make_batch_for(cfg, 8, 16, step=0).items()}
    d = str(tmp_path)
    pool.run(jobs.ckpt_save_sharded, d, cfg, tcfg, "fsdp_tp", 2, batch,
             mesh={"data": 2, "model": 4})
    cm = CheckpointManager(d, async_write=False)
    assert cm.available_steps() == [2] and cm.verify(2)
    meta = cm.read_meta(2)
    assert meta["mesh"] == {"data": 2, "model": 4} and meta["strategy"] == "fsdp_tp"
    saved = cm._assemble(os.path.join(d, "ckpt_2.npz"), meta)
    assert max(np.abs(v).max() for k, v in saved.items() if k.startswith("opt/nu/")) > 0
    for dst in sorted(STRATEGIES):
        mesh = {"data": 4, "model": 1} if dst in ("dp", "fsdp") else {"data": 2, "model": 2}
        whole, mode, step = pool.run(jobs.ckpt_restore_whole, d, cfg, tcfg, dst,
                                     mesh=mesh)[0]
        assert step == 2 and mode == "shard-to-shard", dst
        assert set(whole) == set(saved), dst
        for k, v in saved.items():
            np.testing.assert_array_equal(whole[k], v, err_msg=f"{dst} {k}")
