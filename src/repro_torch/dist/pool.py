"""A world of ranks, one process each, over ``torch.distributed`` (gloo):
the port's counterpart of the reference's forced host device pool
(``DEFAULT_POOL = 8`` in ``repro.launch.train``), on which its sharded
LeNet iterations and its sharded LM train step run. An LM job
(``launch.train.train_rank``) builds each rank's state from the seed on the
rank's own device, so no full-width parameter crosses the pool's pickles,
and rank 0 gathers numbers (losses, times, launches), never tensors.

  with Pool(world=8, device="cuda") as pool:
      results = pool.run(job, *args, mesh={"data": 2, "model": 2})

Rank 0 is the caller's process; ranks 1 .. world-1 are spawned once (start
method ``spawn``) and loop on a broadcast of the next job. ``run`` sends
``job`` (a module-level function, pickled by its import path) and a mesh to
every rank. Every rank makes the mesh's process groups it does not have yet
(``dist.sharding.make_groups``, collective over the world); the mesh's ranks
``0 .. size-1`` then call ``job(ctx, *args)``, where ``ctx.mesh`` is their
``Mesh``, and the others skip it; then rank 0 gathers what each rank
returned. A rank that raises fails the job: ``run`` raises ``RankError``
naming it and carrying its traceback.

A rank that raises may leave its peers waiting in the job's collectives, and
a rank may die outright (a crash, an abort). Neither waits out the
collectives' ``TIMEOUT``: a spawned rank reports its error to rank 0 at once
through a queue beside the process group, a watcher thread in rank 0 reads
that queue and the ranks' liveness while a job runs, and on a failure it
stops the world: it kills every spawned rank, so whatever rank 0 waits in
fails within moments. ``run`` then starts a fresh world (new processes, a new
store, no groups) and raises ``RankError`` with every failing rank's
traceback, so one fault fails one job and the next job runs on a world in
step. A job that fails on every rank alike stops the world too.

Every rank computes on ``device``: under ``cuda`` all ranks share card 0,
under ``cpu`` they are CPU processes. gloo is the backend because NCCL
refuses two ranks on one card. The process group is initialised from a
file (``init_method="file://..."``) in a temporary directory of the pool's
own, never a fixed port, so several pools (pytest workers) can run at once.
Each rank's CPU threads and inductor's compile workers are capped at the
host's cores divided by the world size, while the pool is open, and each
rank takes the caller's TF32 settings for matmuls and cuDNN.
"""
from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import resolve_device
from repro_torch.dist.sharding import Mesh, make_groups, mesh_size

BACKEND = "gloo"
# How long a rank waits in a collective for the others: long enough for
# every rank of a trial to compile its iteration at once on a shared host,
# short enough that a rank's failure mid-iteration (the others wait for it
# in a collective) reaches the caller as an error within minutes.
TIMEOUT = datetime.timedelta(seconds=300)


class RankError(RuntimeError):
    """A job raised on one or more ranks."""


@dataclass
class RankContext:
    """What a job sees on its rank: its rank, the world's size, the device,
    the job's mesh, and the process groups made so far."""
    rank: int
    world: int
    device: torch.device
    mesh: Optional[Mesh] = None
    groups: Dict[Tuple[int, ...], dist.ProcessGroup] = field(default_factory=dict)


def _cap_threads(world: int) -> Tuple[int, int]:
    """Cap torch's CPU threads and inductor's compile workers at the cores
    per rank; return the previous values."""
    import torch._inductor.config as inductor_config
    per_rank = max(1, (os.cpu_count() or 1) // world)
    before = (torch.get_num_threads(), inductor_config.compile_threads)
    torch.set_num_threads(per_rank)
    inductor_config.compile_threads = per_rank
    return before


def _run_job(ctx: RankContext, job, errors=None) -> Tuple[bool, Any]:
    """Run ``job`` on this rank; (True, result) or (False, message). A
    spawned rank also puts the message on ``errors`` (rank 0's watcher)
    before it returns, since its peers may be waiting for it in a
    collective."""
    fn, args, axes = job
    make_groups(axes, ctx.groups)
    if ctx.rank >= mesh_size(axes):
        return True, None
    try:
        ctx.mesh = Mesh(axes, ctx.rank, ctx.groups)
        return True, fn(ctx, *args)
    except Exception as e:
        tail = "".join(traceback.format_exception(e)[-12:]).strip()
        msg = f"rank {ctx.rank}: {type(e).__name__}: {e}\n{tail}"
        if errors is not None:
            errors.put((ctx.rank, msg))
        return False, msg


def _serve(rank: int, world: int, init_file: str, device: str,
           tf32: Tuple[bool, bool], errors) -> None:
    """Rank ``rank``'s loop (spawned): take jobs until the None job."""
    _cap_threads(world)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    dist.init_process_group(BACKEND, init_method=f"file://{init_file}",
                            rank=rank, world_size=world, timeout=TIMEOUT)
    ctx = RankContext(rank, world, torch.device(device))
    try:
        while True:
            box = [None]
            dist.broadcast_object_list(box, src=0)
            if box[0] is None:
                break
            dist.gather_object(_run_job(ctx, box[0], errors), None, dst=0)
    finally:
        from torch._inductor.async_compile import shutdown_compile_workers
        shutdown_compile_workers()
        dist.destroy_process_group()


class _Watcher(threading.Thread):
    """While a job runs: the spawned ranks' errors (from their queue) and
    deaths. On the first, it kills every spawned rank (``stop``), so rank
    0 cannot wait for a failed world; ``failures`` lists what it saw."""

    def __init__(self, pool: "Pool"):
        super().__init__(daemon=True, name="pool-watcher")
        self.pool = pool
        self.failures: List[str] = []
        self.done = threading.Event()

    def run(self) -> None:
        pool = self.pool
        while not self.done.is_set():
            try:
                self.failures.append(pool._errors.get(timeout=0.05)[1])
            except queue.Empty:
                pass
            for r, p in enumerate(pool._procs, start=1):
                if not p.is_alive() and not self.failures:
                    self.failures.append(f"rank {r}: died (exit code "
                                         f"{p.exitcode})")
            if self.failures:
                time.sleep(0.5)          # other ranks' reports of the fault
                while True:
                    try:
                        self.failures.append(pool._errors.get_nowait()[1])
                    except queue.Empty:
                        break
                pool._kill()
                return

    def stop(self) -> List[str]:
        self.done.set()
        self.join()
        while True:                      # reports that came in meanwhile
            try:
                self.failures.append(self.pool._errors.get_nowait()[1])
            except queue.Empty:
                return self.failures


class Pool:
    """``world`` ranks over gloo, rank 0 in this process (see the module
    docstring). Close it (``close`` or ``with``) to stop the other ranks and
    destroy this process's default process group."""

    def __init__(self, world: int = 8, device="cuda"):
        if dist.is_initialized():
            raise RuntimeError("a default process group already exists in "
                               "this process; close the other Pool first")
        self.world = int(world)
        self.device = resolve_device(device)
        self.backend = BACKEND
        if self.device.type == "cuda":
            # build the kernel libraries once, before the ranks load them
            from repro_torch.kernels import quantize as Q
            Q.build()
        self._saved = _cap_threads(self.world)
        self._procs: List = []
        self._dir = None
        self._closed = False
        self.starts = 0             # worlds started: 1 + the restarts
        self._start()

    def _start(self) -> None:
        """Spawn ranks 1 .. world-1 and join them in a new default group
        (a new store file), with no subgroups yet."""
        self._dir = tempfile.mkdtemp(prefix="repro_torch_pool_")
        init_file = os.path.join(self._dir, "store")
        # every rank computes as the caller does: TF32 on or off alike
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        spawn = mp.get_context("spawn")
        self._errors = spawn.Queue()
        self._procs = [spawn.Process(target=_serve, name=f"rank{r}",
                                     args=(r, self.world, init_file,
                                           str(self.device), tf32,
                                           self._errors))
                       for r in range(1, self.world)]
        try:
            for p in self._procs:
                p.start()
            dist.init_process_group(BACKEND, init_method=f"file://{init_file}",
                                    rank=0, world_size=self.world,
                                    timeout=TIMEOUT)
        except BaseException:
            self._stop()
            raise
        self.ctx = RankContext(0, self.world, self.device)
        self.starts += 1

    def run(self, fn: Callable, *args, mesh: Mapping[str, int]) -> List[Any]:
        """``fn(ctx, *args)`` on the ranks of ``mesh`` (axis name → size);
        their results, in rank order. Raises ``RankError`` if any raised
        or died, after starting a fresh world for the next job."""
        if self._closed:
            raise RuntimeError("the pool is closed")
        ranks = mesh_size(mesh)
        if not 1 <= ranks <= self.world:
            raise ValueError(f"a mesh of {ranks} ranks asked of a pool of "
                             f"{self.world}")
        job = (fn, args, dict(mesh))
        watcher = _Watcher(self)
        watcher.start()
        out = [None] * self.world
        mine = (True, None)
        try:
            dist.broadcast_object_list([job], src=0)
            mine = _run_job(self.ctx, job)
            if mine[0]:
                dist.gather_object(mine, out, dst=0)
        except Exception as e:          # a peer stopped: the watcher's fault
            mine = (False, f"rank 0: {type(e).__name__}: {e}")
        if not mine[0] and not watcher.failures:
            time.sleep(0.5)             # the peers' reports of the same fault
            self._kill()                # rank 0's own fault: stop the world
        failed = watcher.stop()
        failed += [r[1] for r in [mine] + out[1:ranks]
                   if r is not None and not r[0] and r[1] not in failed]
        if failed:
            self._restart()
            raise RankError("; ".join(failed))
        return [res for _, res in out[:ranks]]

    def _kill(self) -> None:
        for p in self._procs:
            if p.is_alive():
                p.kill()

    def _restart(self) -> None:
        """After a failed job: stop what is left of the world and start a
        fresh one."""
        self._stop(restore=False)
        self._closed = False
        self._start()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            dist.broadcast_object_list([None], src=0)
        finally:
            self._stop()

    def _stop(self, restore: bool = True) -> None:
        self._closed = True
        deadline = time.monotonic() + 60       # for all ranks together
        for p in self._procs:
            if p.pid is not None:
                p.join(timeout=max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        if dist.is_initialized():
            dist.destroy_process_group()
        if restore:
            torch.set_num_threads(self._saved[0])
            import torch._inductor.config as inductor_config
            inductor_config.compile_threads = self._saved[1]
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "Pool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
