"""α-β cost primitives for the four ring collectives
(``repro.perf.costmodel.primitives``, copied).

One collective on an ``n``-device ring moving ``nbytes`` of payload costs

    t = hops(n) · α  +  volume_factor(n) · nbytes / bw

with the classic ring algebra (Thakur et al.; the same decomposition Shi
et al. 1711.05979 and Ulanov et al. 1610.06276 calibrate per primitive):

  all_reduce      volume 2·(n−1)/n    hops 2·(n−1)   (reduce-scatter+all-gather)
  reduce_scatter  volume (n−1)/n      hops n−1
  all_gather      volume (n−1)/n      hops n−1
  all_to_all      volume (n−1)/n      hops n−1       (pairwise exchange)

The link is *not* a pair of module constants: every cost function takes a
``LinkParams(alpha_s, bw_bytes_per_s)`` — either one shared link or a
per-collective mapping — so the same schedule algebra runs with the
documented defaults, with a calibration fitted from measured residuals
(``repro_torch.perf.costmodel.calibrate``), or with hypothetical hardware.

Because every primitive is linear in (α, 1/bw), a whole *schedule* of
calls reduces to two accumulated coefficients per collective kind —
``schedule_coefficients`` below — which is what makes the calibration a
cheap linear-predictor fit no matter how many rows it consumes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Mapping, Tuple, Union

# Canonical collective kinds, in stable order (calibration vectors index
# into this tuple).
COLLECTIVES = ("all_reduce", "reduce_scatter", "all_gather", "all_to_all")


@dataclass(frozen=True)
class LinkParams:
    """One inter-device link: per-hop latency + point-to-point bandwidth."""
    alpha_s: float              # seconds per ring hop
    bw_bytes_per_s: float       # bytes/second on the link

    def to_dict(self) -> Dict[str, float]:
        return {"alpha_s": self.alpha_s,
                "bw_bytes_per_s": self.bw_bytes_per_s}

    @classmethod
    def from_dict(cls, d: Mapping[str, float]) -> "LinkParams":
        return cls(float(d["alpha_s"]), float(d["bw_bytes_per_s"]))


# The documented simulation defaults (the reference's DESIGN.md §5).
DEFAULT_LINK = LinkParams(alpha_s=20e-6, bw_bytes_per_s=12.5e9)

# ``Links``: one shared link, or one per collective kind (missing kinds
# fall back to the "default" entry when present).
Links = Union[LinkParams, Mapping[str, LinkParams]]


def volume_factor(op: str, n: int) -> float:
    """Payload multiplier of ``op`` on an ``n``-device ring."""
    _check(op)
    if n <= 1:
        return 0.0
    if op == "all_reduce":
        return 2.0 * (n - 1) / n
    return (n - 1) / n          # reduce_scatter / all_gather / all_to_all


def hops(op: str, n: int) -> int:
    """Latency-bound ring steps of ``op`` over ``n`` devices."""
    _check(op)
    if n <= 1:
        return 0
    if op == "all_reduce":
        return 2 * (n - 1)
    return n - 1


def _check(op: str) -> None:
    if op not in COLLECTIVES:
        raise ValueError(f"unknown collective {op!r}; have {COLLECTIVES}")


def link_for(op: str, links: Links) -> LinkParams:
    """Resolve the link a collective kind uses under ``links``."""
    _check(op)
    if isinstance(links, LinkParams):
        return links
    if op in links:
        return links[op]
    if "default" in links:
        return links["default"]
    raise KeyError(f"links mapping has no entry for {op!r} and no "
                   f"'default' fallback: {sorted(links)}")


def collective_seconds(op: str, n_devices: int, nbytes: float,
                       links: Links = DEFAULT_LINK) -> float:
    """α-β time of one collective: hops·α + volume/bw."""
    if n_devices <= 1 or nbytes <= 0:
        return 0.0
    lk = link_for(op, links)
    return (hops(op, n_devices) * lk.alpha_s
            + volume_factor(op, n_devices) * nbytes / lk.bw_bytes_per_s)


@dataclass(frozen=True)
class CollectiveCall:
    """One concrete collective of a communication schedule."""
    op: str                     # one of COLLECTIVES
    n_devices: int              # ring size (the mesh axis this runs over)
    nbytes: float               # payload bytes (wire format already applied)
    tensor: str = ""            # what moves: "grad" | "param" | "act"
    axis: str = ""              # mesh axis name ("data" / "model")

    def seconds(self, links: Links = DEFAULT_LINK) -> float:
        return collective_seconds(self.op, self.n_devices, self.nbytes,
                                  links)


def schedule_seconds(calls: Iterable[CollectiveCall],
                     links: Links = DEFAULT_LINK) -> float:
    """Serial α-β total of a schedule (collectives are sequential in the
    measured shard_map body; overlap is a ROADMAP item, not a modeled
    assumption)."""
    return sum(c.seconds(links) for c in calls)


def schedule_coefficients(calls: Iterable[CollectiveCall]
                          ) -> Dict[str, Tuple[float, float]]:
    """Reduce a schedule to per-kind ``(total_hops, total_volume_bytes)``.

    The α-β total is then ``Σ_op hops_op·α_op + vol_op/bw_op`` — linear in
    each link's (α, 1/bw), which the calibration fit exploits.
    """
    out: Dict[str, Tuple[float, float]] = {}
    for c in calls:
        if c.n_devices <= 1 or c.nbytes <= 0:
            continue
        h, v = out.get(c.op, (0.0, 0.0))
        out[c.op] = (h + hops(c.op, c.n_devices),
                     v + volume_factor(c.op, c.n_devices) * c.nbytes)
    return out
