"""The compiled single-device LM step the arch sweep times, on the CPU:
the two kernel custom ops (``repro_torch::flash_attention``,
``repro_torch::ssd_scan``) under ``torch.library.opcheck``, and
``make_train_step(mode=...)`` held to the eager step (which
``tests/test_torch_train.py`` holds to the reference) for each family.
The compiled sharded step is ``tests/test_torch_arch_sharded.py``.

On the CPU a compiled step takes the "aot_eager" backend
(``train.step.compile_fullgraph``): dynamo's graphs, with ``fullgraph=True``,
and AOT autograd's forward and backward, run op by op; the card's runs take
inductor. Configs run in fp32, so eager and compiled
agree to fp32 rounding: loss within 1e-6 relative, parameters within 1e-6
after three sgd steps.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.data import make_batch_for
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ssd_scan as SSD
from repro_torch.perf import sweep as S
from repro_torch.train.step import init_train_state, make_train_step
from repro_torch.tree import tree_leaves

FAMILIES = ("lm", "moe", "ssm")


def _point(family, **over):
    p = S.sample_arch_point(family, np.random.default_rng(0))
    return dataclasses.replace(p, **over)


def _fp32(cfg):
    return dataclasses.replace(cfg, dtype="float32", param_dtype="float32")


def test_flash_attention_op_passes_opcheck():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 8, 4, 8, generator=g, requires_grad=True)
    k = torch.randn(2, 8, 2, 8, generator=g, requires_grad=True)
    v = torch.randn(2, 8, 2, 8, generator=g, requires_grad=True)
    pos = torch.arange(8, dtype=torch.int32)
    torch.library.opcheck(FA.flash_attention_op,
                          (q, k, v, pos, pos, False, 4, 30.0, 0.3))


def test_ssd_scan_op_passes_opcheck():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, 32, 2, 8, generator=g, requires_grad=True)
    dt = torch.rand(1, 32, 2, generator=g, requires_grad=True)
    A = (-torch.rand(2, generator=g)).requires_grad_(True)
    B = torch.randn(1, 32, 1, 4, generator=g, requires_grad=True)
    C = torch.randn(1, 32, 1, 4, generator=g, requires_grad=True)
    D = torch.randn(2, generator=g, requires_grad=True)
    torch.library.opcheck(SSD.ssd_scan_op, (x, dt, A, B, C, D, 16))


@pytest.mark.parametrize("family,mode", [("lm", "jit"), ("moe", "jit_donate"),
                                         ("ssm", "jit")])
def test_compiled_step_matches_eager(family, mode):
    """Three steps of the sweep's point (sgd from warm-up step 0, so lr
    grows): eager vs the compiled step, "jit" leaving the state it is given
    as it was, "jit_donate" writing into it; two graphs, no break."""
    from torch._dynamo.utils import counters
    p = _point(family)
    cfg, tcfg = _fp32(p.model_config()), S.arch_train_config()
    tcfg = dataclasses.replace(tcfg, warmup_steps=2)
    batch = make_batch_for(cfg, 4, p.seq_len, seed=0)
    states = {m: init_train_state(cfg, tcfg, seed=0, device="cpu")
              for m in ("eager", mode)}
    torch.compiler.reset()
    counters.clear()
    steps = {m: make_train_step(cfg, tcfg, mode=m) for m in states}
    for _ in range(3):
        given = states[mode]
        before = [t.clone() for t in tree_leaves(given.params)]
        losses = {}
        for m in states:
            states[m], metrics = steps[m](states[m], batch)
            losses[m] = float(metrics["loss"])
        same = [a.data_ptr() == b.data_ptr() for a, b in
                zip(tree_leaves(states[mode].params), tree_leaves(given.params))]
        if mode == "jit":
            assert not any(same)
            assert all(torch.equal(a, b)
                       for a, b in zip(before, tree_leaves(given.params)))
        else:
            assert all(same)
        assert losses[mode] == pytest.approx(losses["eager"], rel=1e-6)
    for a, b in zip(tree_leaves(states["eager"].params),
                    tree_leaves(states[mode].params)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    assert not counters["graph_break"]
    assert counters["stats"]["unique_graphs"] == 2
