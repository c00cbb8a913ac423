"""Port parity of the sharded programs' placement specs, with no pool:
``models.model.build_decode_caches`` (shapes, dtypes, roles) and
``launch.specs`` (``_cache_pspec``, ``cache_specs``, ``state_shardings``)
against ``repro.models.model`` and ``repro.launch.specs``.

Every arch of ``ARCH_IDS`` at reduced size. The reference's specs are read
through a mapping-shaped mesh (an object with a ``.shape`` dict), never a
``jax.make_mesh`` mesh, whose Explicit axes the image's jax builds. The
train state's specs are held to the reference's ``param_pspecs`` of its
state's trees: the parameters, AdamW's moments, the int8_ef residual, and
adafactor's factored moments (``Param`` axes without the last, or without
the second to last, dim).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.dist import sharding as JSH
from repro.launch import specs as JSP
from repro.models import model as JMD
from repro.train import step as JTS
from repro_torch.configs import TrainConfig, get_config, reduced
from repro_torch.dist import sharding as SH
from repro_torch.launch import specs as SP
from repro_torch.models import model as MD
from repro_torch.perf.planner.space import shard_divisor
from repro_torch.train import step as TS
from repro_torch.tree import reference_leaves, stack_dims, tree_leaves, tree_map

CAP = 24
MESHES = [{"data": 2, "model": 2}, {"data": 2, "model": 4}, {"data": 1, "model": 4},
          {"data": 4, "model": 1}, {"data": 8}]
MESH_IDS = ["2x2", "2x4", "1x4", "4x1", "8"]


class _Mesh:
    """The reference's view of a mesh: its ``.shape``."""

    def __init__(self, shape):
        self.shape = dict(shape)


class _Leaf:
    """A cache leaf as ``mk`` sees it (an opaque leaf to both packages)."""

    def __init__(self, shape, dtype, role):
        self.shape, self.role = tuple(int(s) for s in shape), role
        self.dtype = (str(dtype).split(".")[-1] if isinstance(dtype, torch.dtype)
                      else np.dtype(dtype).name)


def _flat(tree):
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _flat(t)]
    return [tree]


def _cfgs(arch):
    return jax_reduced(jax_get_config(arch)), reduced(get_config(arch))


@pytest.mark.parametrize("B", [4, 3])
@pytest.mark.parametrize("arch", JARCH_IDS)
def test_build_decode_caches_matches_reference(arch, B):
    jcfg, cfg = _cfgs(arch)
    for jdt, dt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        want = _flat(JMD.build_decode_caches(jcfg, B, CAP, jdt, mk=_Leaf))
        got = _flat(MD.build_decode_caches(cfg, B, CAP, dt, mk=_Leaf))
        assert [(x.shape, x.dtype, x.role) for x in got] == \
            [(x.shape, x.dtype, x.role) for x in want]
    caches = MD.init_decode_caches(cfg, B, CAP, device="cpu")
    assert [tuple(t.shape) for t in _flat(caches)] == [x.shape for x in got]
    for t, leaf in zip(_flat(caches), got):
        if leaf.role == "pos":
            assert t.dtype == torch.int32 and bool((t == MD.EMPTY_POS).all())
        else:
            assert not t.any()


@pytest.mark.parametrize("B", [4, 3])
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", JARCH_IDS)
def test_cache_pspec_matches_reference(arch, mesh, B):
    jcfg, cfg = _cfgs(arch)
    leaves = _flat(MD.build_decode_caches(cfg, B, CAP, torch.bfloat16, mk=_Leaf))
    want = [JSH.spec_to_json(JSP._cache_pspec(x.role, x.shape, _Mesh(mesh)))
            for x in leaves]
    got = [SH.spec_to_json(SP._cache_pspec(x.role, x.shape, mesh)) for x in leaves]
    assert got == want
    structs, specs = SP.cache_specs(cfg, B, CAP, SH.Mesh(mesh, 0, {}))
    flat_specs = []
    tree_map(lambda t, s: flat_specs.append(SH.spec_to_json(s)), structs, specs)
    assert flat_specs == want
    assert [tuple(t.shape) for t in _flat(structs)] == [x.shape for x in leaves]
    assert all(t.device.type == "meta" for t in _flat(structs))


def _keystr(path):
    return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]" for k in path)


def _reference_specs(tree, mesh, strategy):
    leaves = jax.tree_util.tree_flatten_with_path(
        JSH.param_pspecs(tree, mesh, strategy), is_leaf=lambda x: isinstance(x, P))[0]
    return {jax.tree_util.keystr(path): JSH.spec_to_json(spec) for path, spec in leaves}


def _ref_key(path):
    return _keystr(tuple("kernel" if k == "weight" else k for k in path))


def _port_tree_specs(params, specs):
    """A spec tree over the port's params, in the reference's layout by
    reference leaf (every layer of a leaf resolves alike)."""
    axes, flat = [], []
    tree_map(lambda p, ax, s: (axes.append(ax), flat.append(s)), params,
             MD.param_axes(params), specs)
    leaves = tree_leaves(params)
    out = {}
    for path, idx in reference_leaves(params):
        assert len({flat[i] for i in idx}) == 1, path
        spec = SH.spec_entries(flat[idx[0]], leaves[idx[0]].ndim)
        if axes[idx[0]].transposed:
            spec = spec[::-1]
        lead = (None,) * len(stack_dims(params, path))
        out[_ref_key(path)] = SH.spec_to_json(SH._trim(lead + tuple(spec)))
    return out


@pytest.mark.parametrize("mesh", MESHES[:3], ids=MESH_IDS[:3])
@pytest.mark.parametrize("strategy", sorted(SH.STRATEGIES))
@pytest.mark.parametrize("arch", JARCH_IDS)
def test_state_shardings_match_reference(arch, strategy, mesh):
    jcfg, cfg = _cfgs(arch)
    params = MD.init_model(cfg, device="cpu")
    for opt, comp in (("adamw", "int8_ef"), ("adafactor", "none"), ("sgd", "none")):
        jstate = jax.eval_shape(lambda: JTS.init_train_state(
            jax.random.PRNGKey(0), jcfg, JTrainConfig(optimizer=opt,
                                                       grad_compression=comp)))
        tcfg = TrainConfig(optimizer=opt, grad_compression=comp)
        state = TS.init_train_state(cfg, tcfg, device="cpu")
        specs = SP.state_shardings(state, mesh, strategy)
        assert specs.opt.step == ()
        want_p = _reference_specs(jstate.params, mesh, strategy)
        assert _port_tree_specs(params, specs.params) == want_p
        assert SP.params_only_shardings(params, mesh, strategy) == specs.params
        if opt == "adafactor":
            assert specs.opt.mu is None
            want = _reference_specs(jstate.opt.nu, mesh, strategy)
            got = {}
            for (path, _), entry in zip(reference_leaves(state.params), specs.opt.nu):
                for j, s in enumerate(entry):
                    got[_ref_key(path) + f"[{j}]"] = SH.spec_to_json(s)
            assert got == want
            assert [len(e) for e in specs.opt.nu] == [len(t) for t in state.opt.nu]
        else:
            assert _port_tree_specs(params, specs.opt.mu) == \
                _reference_specs(jstate.opt.mu, mesh, strategy)
            if opt == "adamw":
                assert _port_tree_specs(params, specs.opt.nu) == \
                    _reference_specs(jstate.opt.nu, mesh, strategy)
            else:
                assert specs.opt.nu is None and jstate.opt.nu is None
        if comp == "int8_ef":
            assert _port_tree_specs(params, specs.ef) == \
                _reference_specs(jstate.ef, mesh, strategy)
        else:
            assert specs.ef is None and jstate.ef is None


def test_state_shardings_blocks_tile_the_state():
    """The four ranks of {data 2, model 2} hold blocks of every state leaf
    (parameters, adafactor's moments, the residual) that together cover it:
    a spec never names a dim its size does not split evenly."""
    cfg = reduced(get_config("smollm-360m"))
    tcfg = TrainConfig(optimizer="adafactor", grad_compression="int8_ef")
    axes = {"data": 2, "model": 2}
    whole = TS.init_train_state(cfg, tcfg, device="cpu")
    specs = SP.state_shardings(whole, axes, "fsdp_tp")
    pairs = []
    for t, sp in ((whole.params, specs.params), (whole.opt.nu, specs.opt.nu),
                  (whole.ef, specs.ef)):
        tree_map(lambda x, s: pairs.append((x, s)), t, sp)
    sharded = 0
    for x, s in pairs:
        idx = torch.arange(x.numel()).reshape(x.shape)
        seen = set()
        for r in range(4):
            block = SH.shard_of_full(idx, s, SH.Mesh(axes, r, {}))
            assert block.numel() * shard_divisor(s, axes) == x.numel()
            seen.update(block.flatten().tolist())
        assert seen == set(range(x.numel()))
        sharded += bool(s)
    assert sharded > len(pairs) // 2
