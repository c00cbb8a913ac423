"""Port parity of sharded serving (``repro_torch.launch.serve.serve_rank``
over a ``Pool`` of 4 CPU ranks, module-scoped) against the port's
single-device decode loop and the reference's ``decode_step`` (un-jitted,
outside a mesh), fp32 weights from the reference's init
(``models.convert.params_from_jax``), fp32 caches, reduced configs:

* qwen2.5-3b under tp at {data 2, model 2}: 4 q and 2 kv heads, both live
  (the kv caches keep their head slice), the MLP split;
* qwen2.5-3b under fsdp_tp at {data 1, model 4}: 2 kv heads do not divide
  4, so attention is whole on each rank (the reference puts model on the
  kv head_dim, which the rank holds whole) and the MLP is split;
* mamba2-370m under tp: the ``conv``/``ssd`` roles, whole on each rank;
* deepseek-v3 under tp: MLA's ``lat``/``rope`` roles (the latent whole),
  the heads and the experts local, every row on every rank (an MoE routes
  the batch as one);
* whisper-tiny under fsdp_tp with a batch of 3, which the data axis does
  not divide: nothing is live in an encoder-decoder, the encoder runs on
  every rank's rows.

``logits_fn`` casts the logits to bf16 even in an fp32 config, so each
step's logits are held at atol = rtol = 1e-4 before that cast (the
reference's through its own ``unembed`` and softcap, with the cast left
out), and the greedy tokens must be equal.
"""
import argparse
import dataclasses
import json
import unittest.mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import model as JMD
from repro.models.layers import pvalues, softcap as jax_softcap, unembed as jax_unembed
from repro_torch.configs import get_config, reduced
from repro_torch.data import make_batch_for
from repro_torch.dist.pool import Pool
from repro_torch.launch import serve
from repro_torch.models import model as MD
from repro_torch.models.convert import params_from_jax
from repro_torch.train import serve as TS

TOL = 1e-4
# arch, mesh, strategy, batch, prompt, generated tokens (deepseek's fewer:
# the reference's MoE dispatch un-jitted takes ~1 s a decode step here)
CASES = {
    "qwen-gqa-live": ("qwen2.5-3b", {"data": 2, "model": 2}, "tp", 4, 6, 5),
    "qwen-kv-whole": ("qwen2.5-3b", {"data": 1, "model": 4}, "fsdp_tp", 4, 6, 5),
    "mamba2": ("mamba2-370m", {"data": 2, "model": 2}, "tp", 4, 6, 5),
    "deepseek": ("deepseek-v3-671b", {"data": 2, "model": 2}, "tp", 4, 3, 3),
    "whisper": ("whisper-tiny", {"data": 2, "model": 2}, "fsdp_tp", 3, 6, 5),
}
REFERENCE_SERVE_KEYS = {"arch", "batch", "prompt_len", "generated", "strategy",
                        "devices", "mesh", "prefill_s", "decode_s",
                        "decode_tok_per_s", "sample_tokens"}


@pytest.fixture(scope="module")
def pool():
    with Pool(world=4, device="cpu") as p:
        yield p


def _cfgs(arch):
    f32 = dict(dtype="float32", param_dtype="float32")
    return (dataclasses.replace(jax_reduced(jax_get_config(arch)), **f32),
            dataclasses.replace(reduced(get_config(arch)), **f32))


def _reference_logits_f32(params, cfg, h):
    """The reference's ``logits_fn`` without its bf16 cast."""
    if cfg.tie_embeddings or "lm_head" not in params:
        logits = jax_unembed(params["embed"], h)
    else:
        logits = jnp.einsum("...d,dv->...v", h, params["lm_head"]["kernel"].value,
                            preferred_element_type=jnp.float32)
    if cfg.final_logit_softcap:
        logits = jax_softcap(logits, cfg.final_logit_softcap)
    return logits


def _reference(jparams, jcfg, batch, B, S, GEN):
    """Greedy decode through the reference's ``decode_step``: fp32 logits a
    step (the one choosing each token) and the tokens."""
    enc_kv = None
    if jcfg.is_encoder_decoder:
        enc_out = JMD.encoder_forward(jparams, jcfg, jnp.asarray(batch["frames"]))
        enc_kv = JMD._stacked_cross_kv(jparams, jcfg, enc_out)
    caches = JMD.init_decode_caches(jcfg, B, S + GEN, dtype=jnp.float32)
    prompt = jnp.asarray(batch["tokens"])
    logits, toks = [], []
    with unittest.mock.patch.object(JMD, "logits_fn", _reference_logits_f32):
        for pos in range(S + GEN - 1):
            cur = prompt[:, pos:pos + 1] if pos < S else toks[-1][:, None]
            lf, caches = JMD.decode_step(jparams, jcfg, caches, cur, pos, enc_kv=enc_kv)
            if pos >= S - 1:
                logits.append(np.asarray(lf, np.float32))
                toks.append(jnp.argmax(lf.astype(jnp.bfloat16), axis=-1))
    return logits, np.stack([np.asarray(t) for t in toks], axis=1)


def _single(params, cfg, batch, B, S, GEN):
    caches = MD.init_decode_caches(cfg, B, S + GEN, dtype=torch.float32, device="cpu")
    enc_kv = (MD.encode(params, cfg, batch["frames"]) if cfg.is_encoder_decoder
              else None)
    with torch.no_grad():
        out = TS.decode_loop(params, cfg, caches, batch["tokens"], GEN, enc_kv=enc_kv,
                             keep_logits=True)
    return [x.numpy() for x in out.step_logits], out.tokens.numpy()


def _sharded(pool, cfg, tree, mesh, strategy, B, S, GEN):
    args = argparse.Namespace(batch=B, prompt_len=S, gen=GEN, seed=0, strategy=strategy)
    ranks = pool.run(serve.serve_rank, cfg, args, tree, True, torch.float32, mesh=mesh)
    logits = [serve.assemble_rows([{**r, "lf": r["step_logits"][i]} for r in ranks], "lf", B)
              for i in range(GEN)]
    return logits, serve.assemble_rows(ranks, "tokens", B), ranks


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_decode_matches_single_device_and_reference(pool, case):
    arch, mesh, strategy, B, S, GEN = CASES[case]
    jcfg, cfg = _cfgs(arch)
    jparams = JMD.init_model(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, pvalues(jparams))
    batch = make_batch_for(cfg, B, S, step=0, seed=0)
    got_l, got_t, ranks = _sharded(pool, cfg, tree, mesh, strategy, B, S, GEN)
    one_l, one_t = _single(params_from_jax(tree, cfg, device="cpu"), cfg, batch, B, S,
                           GEN)
    ref_l, ref_t = _reference(jparams, jcfg, {k: v.numpy() for k, v in batch.items()}, B,
                              S, GEN)
    np.testing.assert_array_equal(got_t, one_t)
    np.testing.assert_array_equal(got_t, ref_t)
    for i in range(GEN):
        np.testing.assert_allclose(got_l[i], one_l[i], atol=TOL, rtol=TOL,
                                   err_msg=f"{case} step {i} vs single device")
        np.testing.assert_allclose(got_l[i], ref_l[i], atol=TOL, rtol=TOL,
                                   err_msg=f"{case} step {i} vs reference")
    # what each rank holds: its rows unless an MoE or an indivisible batch
    # keeps every row, and never less than the reference's spec bytes of a
    # cache dim the layer computes on
    split = B % mesh["data"] == 0 and cfg.moe is None
    for r in ranks:
        assert len(r["rows"]) == (B // mesh["data"] if split else B)
        assert r["resident_param_bytes"] >= r["spec_param_bytes"]
        assert r["resident_cache_bytes"] >= r["spec_cache_bytes"]


def test_sharded_decode_teacher_forced(pool):
    """``forced`` tokens feed the sharded server's decode loop in place of
    its argmax picks: every step's logits equal the single-device loop's
    under the same forcing (qwen, tp at {data 2, model 2}), the forcing
    changes them from the free run's, and the returned tokens stay the
    argmax picks of those logits."""
    arch, mesh, strategy, B, S, GEN = CASES["qwen-gqa-live"]
    _, cfg = _cfgs(arch)
    params = MD.init_model(cfg, seed=0, device="cpu")
    batch = make_batch_for(cfg, B, S, step=0, seed=0)
    forced = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, GEN), dtype=np.int64))
    args = argparse.Namespace(batch=B, prompt_len=S, gen=GEN, seed=0, strategy=strategy)
    ranks = pool.run(serve.serve_rank, cfg, args, None, True, torch.float32, forced,
                     mesh=mesh)
    got = [serve.assemble_rows([{**r, "lf": r["step_logits"][i]} for r in ranks], "lf", B)
           for i in range(GEN)]
    picks = serve.assemble_rows(ranks, "tokens", B)

    def single(force):
        caches = MD.init_decode_caches(cfg, B, S + GEN, dtype=torch.float32, device="cpu")
        with torch.no_grad():
            out = TS.decode_loop(params, cfg, caches, batch["tokens"], GEN,
                                 keep_logits=True, forced=force)
        return [x.numpy() for x in out.step_logits]

    want, free = single(forced), single(None)
    for i in range(GEN):
        np.testing.assert_allclose(got[i], want[i], atol=TOL, rtol=TOL,
                                   err_msg=f"step {i} vs single device, forced")
        np.testing.assert_array_equal(
            picks[:, i], torch.from_numpy(got[i]).to(torch.bfloat16).argmax(-1).numpy())
    assert np.abs(want[1] - free[1]).max() > 1e-2


def test_serve_plan_marks_what_is_live():
    """The live axes become ``LocalDim`` (qwen at model 2: heads, kv heads,
    the MLP; at model 4: the MLP only); nothing is live for whisper."""
    from repro_torch.dist.sharding import Mesh
    from repro_torch.models.layers import LocalDim

    def live(arch, mesh, strategy):
        plan = TS.serve_plan(reduced(get_config(arch)), Mesh(mesh, 0, {}), strategy, 4)
        return plan, sorted({a.logical for ax in TS._leaves_of(
            MD.param_shapes(reduced(get_config(arch))), plan.axes)
            for a in ax if isinstance(a, LocalDim)})

    plan, names = live("qwen2.5-3b", {"data": 2, "model": 2}, "tp")
    assert names == ["heads", "kv_heads", "mlp"] and plan.kv_local and plan.rows_split
    plan, names = live("qwen2.5-3b", {"data": 1, "model": 4}, "fsdp_tp")
    assert names == ["mlp"] and not plan.kv_local
    plan, names = live("whisper-tiny", {"data": 2, "model": 2}, "tp")
    assert names == [] and not plan.kv_local
    plan, names = live("deepseek-v3-671b", {"data": 2, "model": 2}, "tp")
    assert "expert" in names and "heads" in names and not plan.rows_split


def test_launch_serve_sharded_report(pool, capsys):
    """``launch.serve.main`` over the pool: the reference's report keys, the
    pool and one entry per rank, the single-device tokens."""
    argv = ["--reduced", "--device", "cpu", "--batch", "4", "--prompt-len", "5",
            "--gen", "3"]
    served = serve.main(argv + ["--devices", "4", "--strategy", "tp"], pool=pool)
    report = served.report
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == report
    assert REFERENCE_SERVE_KEYS | {"pool", "ranks", "device", "param_count",
                                   "tree_params"} <= set(report)
    assert report["strategy"] == "tp" and report["devices"] == 4
    assert report["mesh"] == [2, 2]
    assert report["pool"] == {"ranks": 4, "backend": "gloo", "cards": 0}
    assert [r["rank"] for r in report["ranks"]] == [0, 1, 2, 3]
    assert [r["rows"] for r in report["ranks"]] == [[0, 1], [0, 1], [2, 3], [2, 3]]
    for r in report["ranks"]:
        assert r["decode_steps"] == 8 and r["decode_ms_per_step"] > 0
        assert set(r["launches"]["flash_by_design"]) >= {"split_kv", "tile", "cuda_core"}
    single = serve.main(argv)
    assert torch.equal(served.tokens, single.tokens)
    assert tuple(served.tokens.shape) == (4, 3) and served.logits.dtype == torch.bfloat16


def test_launch_serve_dry_run_and_one_device_warning(capsys):
    assert serve.main(["--reduced", "--device", "cpu", "--devices", "4",
                       "--strategy", "fsdp_tp", "--dry-run"]) is None
    plan = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert plan["dry_run"] and plan["devices"] == 4 and plan["mesh"] == [2, 2]
    assert plan["strategy"] == "fsdp_tp"
    served = serve.main(["--reduced", "--device", "cpu", "--strategy", "tp",
                         "--batch", "2", "--prompt-len", "3", "--gen", "2"])
    err = capsys.readouterr().err
    assert "WARNING: --strategy tp requested but only 1 device is visible" in err
    assert served.report["devices"] == 1 and served.report["mesh"] == [1, 1]
    assert served.report["strategy"] == "tp" and "ranks" not in served.report
