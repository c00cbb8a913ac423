"""Port parity: the sharded train step's overlap body
(``make_sharded_train_step(..., overlap=True)``: Megatron splits kept
local, per-layer streamed gathers, the partition-aware clip) against the
reference's single-device gradients, the cases of
``tests/test_overlap_parity.py`` but its red ssm one:

* reduced smollm (2 layers) on mesh (4, 2): tp and fsdp_tp under none and
  int8, fsdp_tp under int8_ef (the residual must engage);
* reduced llama4 on a pure-model mesh (1, 8), tp under none and int8: the
  expert FFN column-split (4 experts do not divide 8), capacity and aux
  loss as on one device;
* reduced llama4 fsdp_tp on (4, 2), overlap against the legacy body (the
  batch split changes MoE capacity, so both bodies are held to each other):
  expert-local FFN (4 experts over 2).

One gloo ``Pool`` of 8 CPU ranks for the module; the reference's gradients
come from one subprocess started before it (``test_torch_sharded_step``'s).
Tolerances are the reference test's, per reference leaf: none 2e-5 +
1e-5·max|g|, int8 and int8_ef 2e-5 + 0.75·shard_max/127 (the 2e-5 floor:
the split reductions re-associate); overlap against legacy 2e-5 +
1e-5·max|g_legacy|.
"""
import numpy as np
import pytest

from repro_torch.dist.pool import Pool
from test_torch_sharded_step import (_cfg, _tcfg, check_grads, jobs, port_tree,
                                     read_reference, start_reference)

WORLD = 8
SMOLLM = ("smollm-360m", dict(n_layers=2, d_model=32, vocab=128, d_ff=64), 8, 32, 4)
LLAMA4 = ("llama4-scout-17b-a16e", {}, 8, 32, 1)
LM_CASES = [("tp", "none"), ("fsdp_tp", "none"), ("tp", "int8"),
            ("fsdp_tp", "int8"), ("fsdp_tp", "int8_ef")]
FLOOR = 2e-5


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    proc, dst = start_reference(tmp_path_factory, [SMOLLM, LLAMA4])
    yield proc, dst
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def pool(reference_run):
    with Pool(world=WORLD, device="cpu") as p:
        yield p


@pytest.fixture(scope="module")
def reference(reference_run, pool):
    return read_reference(*reference_run)


def _overlap(pool, ref, model, strategy, comp, mesh):
    arch, red = model[:2]
    cfg = _cfg(arch, red)
    res = pool.run(jobs.sharded_step, cfg, _tcfg(comp), strategy, [True],
                   ref[arch]["params"], ref[arch]["batch"], mesh=mesh)
    ranks = [r[True] for r in res]
    assert len({r["loss"] for r in ranks}) == 1
    check_grads(ranks[0], ref[arch], cfg, comp, floor=FLOOR)
    return cfg, ranks


@pytest.mark.parametrize("strategy,comp", LM_CASES)
def test_lm_overlap_matches_full_batch_grads(pool, reference, strategy, comp):
    _, ranks = _overlap(pool, reference, SMOLLM, strategy, comp,
                        {"data": 4, "model": 2})
    if comp == "int8_ef":
        assert sum(float(np.abs(e).sum()) for r in ranks for e in r["ef"]) > 0, \
            "error feedback never engaged"


@pytest.mark.parametrize("comp", ["none", "int8"])
def test_moe_pure_model_tp_matches_single_device(pool, reference, comp):
    _overlap(pool, reference, LLAMA4, "tp", comp, {"data": 1, "model": 8})


def test_moe_fsdp_tp_overlap_matches_legacy_body(pool, reference):
    arch = LLAMA4[0]
    cfg, ref = _cfg(arch, LLAMA4[1]), reference[arch]
    res = pool.run(jobs.sharded_step, cfg, _tcfg("none"), "fsdp_tp",
                   [False, True], ref["params"], ref["batch"],
                   mesh={"data": 4, "model": 2})[0]
    p0 = port_tree(ref, "params", cfg)
    for j, a in enumerate(p0):
        g_leg = (a - res[False]["params"][j]) / res[False]["lr"]
        g_ov = (a - res[True]["params"][j]) / res[True]["lr"]
        err = float(np.abs(g_ov - g_leg).max())
        lim = FLOOR + 1e-5 * float(np.abs(g_leg).max())
        assert err <= lim, (j, err, lim)
    assert res[False]["loss"] == pytest.approx(res[True]["loss"], abs=1e-6)


def test_overlap_plans_mark_local_and_streamed_dims():
    """smollm at full width on (2, 2) fsdp_tp: 15 heads do not divide 2, so
    attention streams (data and model); d_ff 2560 does, so the MLP keeps its
    hidden local on model and streams embed over data; the embedding, final
    norm are eager; each plan's replication is the ranks holding its grad."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.dist.sharding import param_pspecs
    from repro_torch.models import model as MD
    from repro_torch.models.layers import LocalDim, StreamDim
    from repro_torch.train.step import _overlap_plans
    cfg = get_config("smollm-360m")
    mesh = {"data": 2, "model": 2}
    shapes = MD.param_shapes(cfg)
    plans = _overlap_plans(cfg, TrainConfig(grad_compression="int8"), mesh,
                           param_pspecs(shapes, mesh, "fsdp_tp"), shapes)
    assert MD.tp_live_axes(cfg, 2) == frozenset({"mlp"})
    layer = plans["segments"][0][5]
    assert layer["attn"]["wq"]["weight"].axes == (
        StreamDim("heads", "model"), StreamDim("embed", "data"))
    assert layer["mlp"]["up"]["weight"].axes == (
        LocalDim("mlp", "model", 2), StreamDim("embed", "data"))
    assert layer["mlp"]["down"]["weight"].axes == (
        StreamDim("embed", "data"), LocalDim("mlp", "model", 2))
    assert layer["mlp"]["up"]["weight"].repl == 1.0
    assert layer["ln1"]["scale"] == ((None,), (None,), False, 4.0)
    assert not plans["embed"]["table"].streamed
    assert plans["embed"]["table"].gather == ("model", "data")


@pytest.mark.parametrize("arch,remat,over", [
    ("deepseek-v3-671b", "dots", {}),          # MLA local heads, MTP, experts
    ("smollm-360m", "full", {}),               # streamed gathers recomputed
    ("zamba2-1.2b", "none", dict(n_layers=5, shared_attn_every=2)),
])
def test_overlap_matches_legacy_body(pool, arch, remat, over):
    """Both bodies from one seeded port init on (2, 2) fsdp_tp, fp32: the
    overlap body's update is the legacy body's within 2e-5 + 1e-5·max|g|
    (MLA's head split with MTP; a remat that reruns the streamed gathers in
    the backward; a zamba group's shared block, never streamed, with its
    heads local)."""
    import dataclasses
    from repro_torch.configs import TrainConfig, get_config, reduced
    from repro_torch.data import make_batch_for
    from repro_torch.dist import probes
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32",
                              param_dtype="float32", **over)
    tcfg = TrainConfig(learning_rate=1.0, optimizer="sgd", beta1=0.0,
                       weight_decay=0.0, grad_clip=1e9, total_steps=10,
                       warmup_steps=0, remat_policy=remat, grad_compression="none")
    batch = {k: v.numpy() for k, v in make_batch_for(cfg, 8, 32, step=0).items()}
    res = pool.run(probes.sharded_bodies, cfg, tcfg, "fsdp_tp", 0, batch,
                   mesh={"data": 2, "model": 2})
    for j in range(len(res[0]["err"])):
        err = max(r["err"][j] for r in res)
        lim = FLOOR + 1e-5 * max(r["gmax"][j] for r in res)
        assert err <= lim, (j, err, lim)
    assert res[0]["loss"][True] == pytest.approx(res[0]["loss"][False], rel=1e-6)
