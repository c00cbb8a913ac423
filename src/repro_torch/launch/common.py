"""Shared plumbing of the port's benchmark drivers (``benchmarks/common.py``):
the modes, the ``emit`` record line, the LeNet sweep rows that the paper's
tables fit, and memoised fits on them.

The reference reads ``benchmarks/artifacts/lenet_sweep.json`` and, when it
is missing, measures 120 trials and writes that file. The port writes no
checked-in file: a ``Sweep`` holds rows read from a path (as
``launch.fit_perfmodel --rows-out`` writes them) or measured in the process
on the card (``perf.sweep.run_sweep``), and memoises the fits made on them.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

from repro_torch.launch.dryrun import DEFAULT_OUTDIR as DRYRUN_DIR

MODES = ("jit", "jit_donate", "eager")
SWEEP_TRIALS = 120          # the reference's reduced sweep when its cache is missing


SRC = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def module_env() -> Dict[str, str]:
    """This environment with the port's ``src`` first on ``PYTHONPATH``: what
    a ``python -m repro_torch...`` subprocess of a driver runs under."""
    return {**os.environ,
            "PYTHONPATH": os.pathsep.join(p for p in (SRC, os.environ.get("PYTHONPATH"))
                                          if p)}


def emit(name: str, **kv) -> None:
    """CSV-ish single-line record (the harness contract)."""
    parts = [name] + [f"{k}={v}" for k, v in kv.items()]
    print(",".join(parts), flush=True)


def load_rows(path: str = "", trials: int = SWEEP_TRIALS, device="cuda",
              seed: int = 0) -> List[Dict]:
    """The LeNet sweep rows at ``path``, or ``trials`` trials measured on
    ``device`` now (trial i in ``MODES[i % 3]``, as the reference's)."""
    if path:
        with open(path) as f:
            return json.load(f)
    from repro_torch.perf.sweep import run_sweep
    print(f"  [no rows given: measuring {trials} trials on {device}]", flush=True)
    return run_sweep(n_trials=trials, seed=seed, device=device, verbose_every=25)


class Sweep:
    """A sweep's rows and the fits made on them, each split and each fit
    computed once (``benchmarks.common._split`` and ``fit_cached``)."""

    def __init__(self, rows: List[Dict], device="cuda"):
        from repro_torch import resolve_device
        self.rows = rows
        self.device = resolve_device(device)
        self._splits: Dict[str, Tuple] = {}
        self._fits: Dict[Tuple, object] = {}

    @property
    def modes(self) -> Tuple[str, ...]:
        """The modes of ``MODES`` that the rows hold (the reference's sweep
        holds all three; ``fit_perfmodel --rows-out`` writes one)."""
        held = {r["mode"] for r in self.rows if "error" not in r}
        return tuple(m for m in MODES if m in held)

    def split(self, mode: str):
        """(fit features, fit times, test features, test times) of ``mode``
        (``perf.sweep.split_rows``)."""
        if mode not in self._splits:
            from repro_torch.perf.sweep import split_rows
            self._splits[mode] = split_rows(self.rows, mode)
        return self._splits[mode]

    def fit_cached(self, mode: str, reg: str, lam: float, seeds: int = 10,
                   maxiter: int = 300):
        """The generic model fitted on ``mode``'s rows, once per argument set."""
        key = (mode, reg, lam, seeds, maxiter)
        if key not in self._fits:
            from repro_torch.core.fit import fit_model
            from repro_torch.perf.features import LENET_SPEC
            f_s, t_s, f_t, t_t = self.split(mode)
            self._fits[key] = fit_model(
                LENET_SPEC, f_s, t_s, test_samples=f_t, test_times=t_t, reg=reg,
                lam=lam, seeds=tuple(range(seeds)), maxiter=maxiter,
                device=self.device)
        return self._fits[key]

