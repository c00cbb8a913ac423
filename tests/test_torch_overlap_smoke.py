"""``tp_probe`` / ``tp_probe_sink`` (``repro_torch.models.layers``) against
the reference's (``repro.models.layers``), the overlap smoke's claim 1
(``repro_torch.tools.overlap_smoke``) and the overlap benchmark's
plumbing (``repro_torch.launch.overlap``, ``benchmarks/overlap.py``) on the
CPU: the probe is the identity, the sink records the reference's tags and
shapes (as sets: the reference's scan traces a layer once, the port's
loop runs each), and on a world of 8 CPU ranks the overlapped tp body's
local ``mlp_hidden`` is d_ff/8 of the sequential body's."""
import ast
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.configs.lenet5 import LeNet5Config as JaxLeNet5Config
from repro.data import lenet_batch as jax_lenet_batch
from repro.data import make_batch_for as jax_make_batch_for
from repro.models import lenet as JL
from repro.models import model as JM
from repro.models.layers import tp_probe_sink as jax_sink
from repro_torch.configs import get_config, reduced
from repro_torch.configs.lenet5 import LeNet5Config
from repro_torch.data import lenet_batch, make_batch_for
from repro_torch.dist.pool import Pool
from repro_torch.launch import overlap as OV
from repro_torch.models import lenet as L
from repro_torch.models import model as MD
from repro_torch.models.layers import tp_probe, tp_probe_sink
from repro_torch.tools import overlap_smoke as OS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's DE fits run many small ops: one intra-op thread keeps them
    fast when the suite runs test files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def test_probe_is_the_identity_and_the_sink_nests():
    x = torch.randn(3, 5)
    assert tp_probe("t", x) is x
    with tp_probe_sink([]) as outer:
        tp_probe("a", x)
        with tp_probe_sink([]) as inner:
            tp_probe("b", x[:1])
        tp_probe("c", x)
    assert outer == [("a", (3, 5)), ("c", (3, 5))] and inner == [("b", (1, 5))]
    assert tp_probe("d", x) is x      # no sink: nothing recorded, nothing raised


def test_probe_adds_no_graph_break():
    from repro_torch.train.step import compile_fullgraph
    fn = compile_fullgraph(lambda x: tp_probe("t", x) * 2)
    with tp_probe_sink([]) as rec:
        out = fn(torch.ones(4))
    assert torch.equal(out, torch.full((4,), 2.0)) and rec == []


@pytest.mark.parametrize("arch", ["smollm-360m", "llama4-scout-17b-a16e"])
def test_sink_records_the_reference_tags_and_shapes(arch):
    cfg, jcfg = reduced(get_config(arch)), jax_reduced(jax_get_config(arch))
    with tp_probe_sink([]) as got:
        MD.loss_fn(MD.init_model(cfg, seed=0, device="cpu"), cfg,
                   make_batch_for(cfg, 4, 16))
    params = jax.eval_shape(lambda: JM.init_model(jax.random.PRNGKey(0), jcfg))
    with jax_sink([]) as want:           # traced once, as the reference's smoke
        jax.jit(lambda p, b: JM.loss_fn(p, jcfg, b)).lower(
            params, jax_make_batch_for(jcfg, 4, 16))
    assert set(got) == set(want) and got
    assert {t for t, _ in got} == ({"attn_q", "moe_hidden"} if cfg.moe
                                   else {"attn_q", "mlp_hidden"})


def test_sink_records_the_reference_lenet_fc1():
    kw = dict(n_filters=8, batch_size=16, dropout=0.0)
    cfg, jcfg = LeNet5Config(**kw), JaxLeNet5Config(**kw)
    with tp_probe_sink([]) as got:
        L.lenet_forward(L.init_lenet(cfg, seed=0, device="cpu"),
                        lenet_batch(cfg, device="cpu")["images"], cfg)
    params = jax.eval_shape(lambda: JL.init_lenet(jax.random.PRNGKey(0), jcfg))
    with jax_sink([]) as want:
        jax.jit(lambda p, x: JL.lenet_forward(p, x, jcfg)).lower(
            params, jax_lenet_batch(jcfg)["images"])
    assert got == want == [("lenet_fc1", (16, 120))]


def test_overlap_constants_are_the_reference():
    tree = ast.parse(open(os.path.join(ROOT, "benchmarks", "overlap.py")).read())
    ref = {}
    for node in tree.body:
        if isinstance(node, ast.Assign):
            names = [getattr(t, "id", None) for t in node.targets]
            if isinstance(node.targets[0], ast.Tuple):
                names = [e.id for e in node.targets[0].elts]
                ref.update(zip(names, ast.literal_eval(node.value)))
            elif names[0] in ("ARCHS", "STRATEGIES"):
                ref[names[0]] = ast.literal_eval(node.value)
    assert (OV.ARCHS, OV.STRATEGIES, OV.B, OV.S, OV.ITERS) == (
        ref["ARCHS"], ref["STRATEGIES"], ref["B"], ref["S"], ref["ITERS"])


@pytest.fixture(scope="module")
def pool():
    with Pool(world=8, device="cpu") as p:
        yield p


def test_claim_one_on_a_cpu_pool(pool):
    """Claim 1 on 8 CPU ranks, tp at (data 1, model 8): reduced smollm's
    overlapped local mlp_hidden is [8, 32, 128 / 8]."""
    out = OS.claim_partition(pool)
    assert out["mesh"] == {"data": 1, "model": 8}
    assert out["mlp_hidden_full"] == [(OS.B, OS.S, 128)]
    assert out["mlp_hidden_local"] == [(OS.B, OS.S, 16)]


def test_overlap_point_on_a_cpu_pool(pool):
    """One point of the benchmark (llama4 fsdp_tp, 2 timed steps): both
    bodies timed on every rank, the price the reference's formula's."""
    from repro_torch.perf.costmodel import DEFAULT_CALIBRATION
    mp = pytest.MonkeyPatch()
    mp.setattr(OV, "ITERS", 2)
    try:
        row = OV.run_point(pool, "llama4-scout-17b-a16e", "fsdp_tp", DEFAULT_CALIBRATION)
    finally:
        mp.undo()
    assert row["mesh"] == {"data": 4, "model": 2}
    assert row["seq_ms"] > 0 and row["overlap_ms"] > 0
    assert row["ratio"] == pytest.approx(row["overlap_ms"] / row["seq_ms"])
    assert np.isfinite([row["comm_ms"], row["rho"], row["exposed_ms"]]).all()
    assert row["exposed_ms"] == pytest.approx(
        max(0.0, row["comm_ms"] - row["rho"] * row["overlap_ms"]))
    md = OV.render_md([row], 1.0, "cpu")
    assert "| llama4-scout-17b-a16e | fsdp_tp | data:4×model:2 |" in md
