"""Per-architecture feature specs for the generic performance model
(``repro.perf.features``, copied: the whole registry, so the checked-in
lm/moe/ssm sweep rows fit under the port too).

The paper's central claim is *one* generic expression that transfers
across applications. The repo therefore keys a registry of
``ArchSpec`` entries by architecture **family** — each family maps its
own intrinsics (LeNet's kernel/pool/filter shapes; a transformer LM's
seq_len/d_model/n_layers/d_ff; an MoE's n_experts/top_k; an SSM's state
dim) into the same expression, while every family shares the same
extrinsic axes (n_devices, batch_size, wire_bits) and the categorical
sharding-strategy constant. One fit per family, one functional form for
all of them — that is what "generic" means operationally here.

Families:

  lenet   the paper's own Table-1 subject (``repro_torch.configs.lenet5``)
  lm      dense transformer LM — ``reduced(smollm_360m)``
  moe     mixture-of-experts — ``reduced(llama4_scout)``
  ssm     state-space model — ``reduced(mamba2_370m)``

``LENET_SPEC`` / ``lenet_features`` remain as *deprecated aliases*
(resolved lazily through the registry via module ``__getattr__``, so
importing this module no longer pulls the LeNet config constants in at
import time); new code should call ``get_spec(family)``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Tuple

from repro_torch.core.generic_model import FeatureSpec

# The four registry strategies (mirrors
# ``repro_torch.dist.sharding.STRATEGIES``).
DIST_STRATEGIES = ("dp", "fsdp", "tp", "fsdp_tp")

# Extrinsics shared by every family: the paper's genericity claim is
# that the same multiplicative E_j^{q_j} terms scale any application.
SHARED_EXTRINSICS = ("n_devices", "batch_size", "wire_bits")


@dataclass(frozen=True)
class ArchSpec:
    """One family's entry in the feature-spec registry.

    ``norm_unit`` is the fit-target work unit (docs/METHODOLOGY.md):
    LeNet iterations are normalized per *sample* (REF_SAMPLES), token
    sequence models per *token* (batch × seq_len, REF_TOKENS) — an
    iteration over twice the sequence length does twice the work, which
    a per-sample unit would misread as the model getting slower.

    ``spec_tag`` is the persistence tag written into fitted artifacts
    (``planner_model.json``) so a loaded model resolves back to the
    spec that shaped its constant vector.
    """
    family: str
    arch_id: str                         # default config the sweep reduces
    spec: FeatureSpec
    norm_unit: str                       # "sample" | "token"
    spec_tag: str
    intrinsic_space: Mapping[str, Tuple] # sampled value sets per intrinsic
    features: Callable[[object], Dict]   # config/point -> raw feature dict


_BUILDERS: Dict[str, Callable[[], ArchSpec]] = {}
_CACHE: Dict[str, ArchSpec] = {}


def register_family(name: str):
    def deco(fn: Callable[[], ArchSpec]):
        _BUILDERS[name] = fn
        return fn
    return deco


def families() -> Tuple[str, ...]:
    return tuple(_BUILDERS)

def get_spec(family: str) -> ArchSpec:
    """Resolve one family's ArchSpec (built lazily, cached)."""
    if family not in _CACHE:
        if family not in _BUILDERS:
            raise KeyError(f"unknown architecture family {family!r}; "
                           f"known: {sorted(_BUILDERS)}")
        _CACHE[family] = _BUILDERS[family]()
    return _CACHE[family]


def spec_for_tag(tag: str) -> ArchSpec:
    """Resolve a persisted artifact's spec tag back to its ArchSpec."""
    for family in _BUILDERS:
        s = get_spec(family)
        if s.spec_tag == tag:
            return s
    raise KeyError(f"unknown feature-spec tag {tag!r}; known: "
                   f"{sorted(get_spec(f).spec_tag for f in _BUILDERS)}")


# ---------------------------------------------------------------------------
# lenet — the paper's Table-1 space
# ---------------------------------------------------------------------------

def _lenet_features(cfg) -> Dict:
    return {**cfg.intrinsic_dict(), **cfg.extrinsic_dict(),
            **cfg.dist_dict()}


@register_family("lenet")
def _build_lenet() -> ArchSpec:
    # Table 1, split per the paper's treatment: numeric intrinsics get
    # power terms; categorical intrinsics get per-value constants; the
    # "framework" axis of the paper maps to our execution-mode axis
    # (DESIGN.md §5). Beyond the paper: the sharding strategy
    # (categorical constant) and the gradient wire width (numeric
    # extrinsic power term — 32/16/8 bits for none/bf16/int8) enter so
    # one fit predicts across the distributed scenarios the reference can
    # actually run. Config constants are imported here, not at module
    # import time — the registry must not force LeNet on every consumer.
    from repro_torch.configs.lenet5 import (ACTIVATIONS, DATASETS,
                                      DIST_STRATEGIES as LENET_STRATEGIES,
                                      DROPOUTS, KERNEL_SIZES,
                                      LEARNING_RATES, N_FILTERS, OPTIMIZERS,
                                      PADDING_MODES, POOL_SIZES, STRIDES)
    spec = FeatureSpec(
        numeric=("kernel_size", "pool_size", "n_filters", "learning_rate",
                 "stride", "dropout"),
        categorical=(("activation", ACTIVATIONS),
                     ("optimizer", OPTIMIZERS),
                     ("dataset", DATASETS),
                     ("padding", PADDING_MODES),
                     ("strategy", LENET_STRATEGIES)),
        extrinsic=SHARED_EXTRINSICS,
    )
    space = {"kernel_size": KERNEL_SIZES, "pool_size": POOL_SIZES,
             "n_filters": N_FILTERS, "learning_rate": LEARNING_RATES,
             "stride": STRIDES, "dropout": DROPOUTS}
    return ArchSpec(family="lenet", arch_id="lenet5", spec=spec,
                    norm_unit="sample", spec_tag="lenet-table1-v1",
                    intrinsic_space=space, features=_lenet_features)


# ---------------------------------------------------------------------------
# Sequence families: lm / moe / ssm
# ---------------------------------------------------------------------------

def _seq_features(spec: FeatureSpec):
    """Feature extractor over any point-like object carrying the spec's
    numeric intrinsics plus the shared extrinsic/strategy attributes."""
    def feats(point) -> Dict:
        out = {f: getattr(point, f) for f in spec.numeric}
        out.update(strategy=point.strategy,
                   n_devices=point.n_devices,
                   batch_size=point.batch_size,
                   wire_bits=point.wire_bits,
                   # provenance (not consumed by the encoder)
                   compression=point.compression,
                   family=point.family, arch=point.arch_id)
        return out
    return feats


def _seq_spec(numeric: Tuple[str, ...]) -> FeatureSpec:
    return FeatureSpec(numeric=numeric,
                       categorical=(("strategy", DIST_STRATEGIES),),
                       extrinsic=SHARED_EXTRINSICS)


@register_family("lm")
def _build_lm() -> ArchSpec:
    spec = _seq_spec(("seq_len", "d_model", "n_layers", "d_ff"))
    space = {"seq_len": (16, 32, 64), "d_model": (32, 64),
             "n_layers": (1, 2, 3), "d_ff": (64, 128)}
    return ArchSpec(family="lm", arch_id="smollm-360m", spec=spec,
                    norm_unit="token", spec_tag="arch:lm-v1",
                    intrinsic_space=space, features=_seq_features(spec))


@register_family("moe")
def _build_moe() -> ArchSpec:
    spec = _seq_spec(("seq_len", "d_model", "n_layers", "d_ff",
                      "n_experts", "top_k"))
    space = {"seq_len": (16, 32, 64), "d_model": (32, 64),
             "n_layers": (1, 2), "d_ff": (64, 128),
             "n_experts": (2, 4, 8), "top_k": (1, 2)}
    return ArchSpec(family="moe", arch_id="llama4-scout-17b-a16e",
                    spec=spec, norm_unit="token", spec_tag="arch:moe-v1",
                    intrinsic_space=space, features=_seq_features(spec))


@register_family("ssm")
def _build_ssm() -> ArchSpec:
    # pure-SSM blocks carry no MLP (mamba2 d_ff = 0), so d_ff is out and
    # the SSD state dimension is the family-defining intrinsic instead.
    spec = _seq_spec(("seq_len", "d_model", "n_layers", "d_state"))
    space = {"seq_len": (16, 32, 64), "d_model": (32, 64),
             "n_layers": (1, 2, 3), "d_state": (8, 16, 32)}
    return ArchSpec(family="ssm", arch_id="mamba2-370m", spec=spec,
                    norm_unit="token", spec_tag="arch:ssm-v1",
                    intrinsic_space=space, features=_seq_features(spec))


# ---------------------------------------------------------------------------
# Deprecated aliases (PEP 562): resolved through the registry on first
# access, so `from repro_torch.perf.features import LENET_SPEC` works
# without reintroducing the import-time LeNet dependency.
# ---------------------------------------------------------------------------

_DEPRECATED = {"LENET_SPEC": lambda: get_spec("lenet").spec,
               "lenet_features": lambda: get_spec("lenet").features}


def __getattr__(name: str):
    if name in _DEPRECATED:
        return _DEPRECATED[name]()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_DEPRECATED))
