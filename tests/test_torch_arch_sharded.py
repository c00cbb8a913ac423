"""The compiled overlap body of ``make_sharded_train_step`` on a world of
2 CPU ranks, held to the eager overlap body (which
``tests/test_torch_overlap.py`` holds to the reference) for each family,
and ``python -m repro_torch.launch.arch_sweep`` measuring two trials on the
CPU into rows of the reference's ``SweepRow`` schema.

Compiled cases take the "aot_eager" backend on the CPU
(``train.step.compile_fullgraph``); configs run in fp32: losses within 1e-6 relative, parameters
within 1e-6 after three sgd steps.
"""
import dataclasses
import json

import numpy as np
import pytest

from repro_torch.data import make_batch_for
from repro_torch.dist.pool import Pool
from repro_torch.perf import sweep as S
from test_torch_arch_compile import _fp32, _point


@pytest.fixture(scope="module")
def pool():
    with Pool(world=2, device="cpu") as p:
        yield p


@pytest.mark.parametrize("family,strategy,comp", [
    ("lm", "fsdp_tp", "int8_ef"), ("moe", "tp", "none"),
    ("ssm", "fsdp", "bf16")])
def test_compiled_sharded_step_matches_eager_overlap(pool, family, strategy,
                                                     comp):
    """The compiled overlap body on 2 ranks (its gathers, its forward with
    the Megatron splits and streamed gathers, the wire-compressed
    reduction) against the eager overlap body: three regions, no graph
    break, the same losses and parameters."""
    p = _point(family, strategy=strategy, compression=comp, n_devices=2)
    cfg, tcfg = _fp32(p.model_config()), S.arch_train_config(comp)
    tcfg = dataclasses.replace(tcfg, warmup_steps=1)
    batch = {k: v.numpy() for k, v in
             make_batch_for(cfg, 8, p.seq_len, seed=0).items()}
    from repro_torch.dist import probes
    res = pool.run(probes.sharded_modes, cfg, tcfg, strategy, 0, batch, "jit",
                   3, mesh=S.arch_mesh_axes(strategy, 2))
    for r in res:
        assert r["jit"]["graph_breaks"] == 0 and r["jit"]["graphs"] == 3
        np.testing.assert_allclose(r["jit"]["losses"], r["eager"]["losses"],
                                   rtol=1e-6)
        assert r["param_diff"] <= 1e-6


def test_entry_point_measures_rows_of_the_reference_schema(pool, tmp_path):
    """``--device cpu --quick --families lm --trials 2`` on the module's
    world of 2: two rows whose keys, in order, are the reference's
    ``SweepRow``'s; the first point (2 ranks) has its sharded column, the
    second (4) the reference's "pool-too-small" sentinel."""
    from repro.perf.sweep import SweepRow as JSweepRow
    from repro_torch.launch import arch_sweep
    arch_sweep.main(["--device", "cpu", "--quick", "--families", "lm",
                     "--trials", "2", "--out", str(tmp_path)], pool=pool)
    rows = json.load(open(tmp_path / "arch_sweep_lm.json"))
    keys = [f.name for f in dataclasses.fields(JSweepRow)]
    assert len(rows) == 2
    for r in rows:
        assert list(r) == keys, r
        assert r["mode"] == "jit" and r["family"] == "lm"
        assert r["measured_ms"] > 0 and r["t_simulated"] >= r["measured_ms"]
    assert [r["features"]["n_devices"] for r in rows] == [2, 4]
    assert rows[0]["t_measured_sharded"] > 0 and rows[0]["sharded_skip"] is None
    assert (rows[1]["t_measured_sharded"], rows[1]["sharded_skip"]) == \
        (None, S.SKIP_POOL)
