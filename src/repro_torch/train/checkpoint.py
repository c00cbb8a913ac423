"""Fault-tolerant checkpointing: atomic, versioned, async, sharded
(``repro.train.checkpoint``, with the reference's on-disk contract; the
multi-process design is the port's own).

Two formats share one ``.npz`` + JSON-sidecar layout (``ckpt_<step>.npz``
and ``ckpt_<step>.npz.json``; ``_DATA_SUFFIX``/``_META_SUFFIX`` are the one
source of the pair for save, restore and GC):

* **full** (``save``, ``full-v1``): leaf path → whole array, for a state
  one process holds whole (the single-device step).
* **sharded** (``save_sharded``, ``sharded-v1``): each leaf written as its
  distinct blocks (npz key ``<leaf path>@@<grid coordinate>``); the sidecar
  records the mesh shape, the strategy and every leaf's spec
  (``dist.sharding.spec_to_json``), so a restore can cut the state again
  under another (mesh, strategy): fsdp on 8 ranks → tp on 4 after losing
  half of them.

Leaf paths are the port's tree paths joined by ``/``: a NamedTuple's field
names (``params``, ``opt/mu``, ...), dict keys, list indices; a None subtree
has no leaf, a host integer (the optimizer's step count) is a 0-d entry.
bf16 is stored as fp32 (lossless; npz has no bf16) and cast back on restore.

**Across the ranks of a pool.** The reference holds every shard in one
process (``jax.Array.addressable_shards``); the port's state is split over
pool ranks, one process each. ``save_sharded`` given a ``dist.sharding.Mesh``
is a collective over the mesh's ranks: each rank takes the blocks it holds
and is the lowest rank to hold (index 0 on every mesh axis its spec does not
use), as host copies, and sends them to rank 0 over gloo (host bytes,
rank by rank: gloo's gathers of CUDA tensors crash); rank 0 writes the
one file, the others return. ``collect_sharded`` is the collective half
alone, so that a supervised retry of the write (``launch.train``) repeats
rank 0's write and not the gather. On restore every rank opens the file
itself and reads only the blocks that overlap its own slice under the
target (mesh, specs) (``_LazyBlocks``, ``assemble_region``), then places
that slice on its device: **shard-to-shard**, no rank assembles a tensor
it does not hold. A caller on a pool agrees on the step its ranks restored
(``launch.train``: the lowest, restored again where a rank found a newer
one intact), since each rank verifies only the entries it reads.

Writes go to a temp file and ``os.replace`` (atomic on POSIX). A background
thread serialises; ``wait()`` joins it and re-raises what it hit, so a flaky
disk surfaces as an exception the supervisor's retry policy classifies.
``fault_hook(op, step)`` runs at the start of every payload write and may
raise (tests, ``--inject-ckpt-fault``). The sidecar records a CRC32 per npz
entry; restore verifies every entry it reads (a mismatch, like a torn or
garbled file, falls back to the next older checkpoint, newest first), and GC
counts only verified checkpoints toward ``keep``.
"""
from __future__ import annotations

import json
import os
import re
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.dist.sharding import (Mesh, assemble_region, assemble_shards,
                                       axis_sizes, shard_coord, shard_grid,
                                       shard_region, spec_entries, spec_from_json,
                                       spec_to_json, _axes_of)

_CKPT_RE = re.compile(r"ckpt_(\d+)\.npz$")

# The suffix pair: data file and its sidecar. ``available_steps`` requires
# both; ``_gc`` removes exactly both.
_DATA_SUFFIX = ".npz"
_META_SUFFIX = ".npz.json"          # == _DATA_SUFFIX + ".json"

# npz-key separator between a leaf's path and its shard-grid coordinate.
_SHARD_SEP = "@@"

FORMAT_FULL = "full-v1"
FORMAT_SHARDED = "sharded-v1"


class ChecksumError(ValueError):
    """An npz entry does not match its sidecar CRC: the payload is silently
    corrupt (a valid zip, wrong bytes). Restore skips to the next older
    checkpoint."""


class ShapeDtype(NamedTuple):
    """A restore skeleton's leaf when no tensor stands for it."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


class Placement(NamedTuple):
    """Where a restore puts a state: ``specs`` (a spec tree walked beside
    the skeleton: a spec at every tensor, ``()`` at a host integer) on this
    rank's ``mesh``, each leaf's slice on ``device``."""
    mesh: Mesh
    specs: Any
    device: Any


def _crc(arr: np.ndarray) -> int:
    """CRC32 over an entry's dtype, shape and raw bytes."""
    a = np.ascontiguousarray(arr)
    c = zlib.crc32(repr((a.dtype.str, a.shape)).encode())
    return zlib.crc32(a.tobytes(), c) & 0xFFFFFFFF


def _host(leaf) -> np.ndarray:
    """A host numpy copy of a leaf; bf16 (and other floats numpy lacks)
    upcast to fp32, losslessly."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(leaf)


def _is_namedtuple(x) -> bool:
    return (isinstance(x, tuple) and hasattr(x, "_fields")
            and not isinstance(x, ShapeDtype))


def _walk(tree, other=None, path=()):
    """(path, leaf, other's leaf) of every leaf of ``tree``, with ``other``
    (a tree of the same structure, or None) walked beside it, driven by
    ``tree`` (a spec tree's leaves are tuples). A None subtree has no leaf."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, None if other is None else other[k], path + (str(k),))
    elif _is_namedtuple(tree):
        for k in tree._fields:
            yield from _walk(getattr(tree, k),
                             None if other is None else getattr(other, k), path + (k,))
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, ShapeDtype):
        for i, v in enumerate(tree):
            yield from _walk(v, None if other is None else other[i], path + (str(i),))
    else:
        yield path, tree, other


def _rebuild(tree, fn, path=()):
    """``tree``'s structure with each leaf replaced by ``fn(path, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, path + (str(k),)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(getattr(tree, k), fn, path + (k,))
                            for k in tree._fields))
    if isinstance(tree, (list, tuple)) and not isinstance(tree, ShapeDtype):
        return type(tree)(_rebuild(v, fn, path + (str(i),)) for i, v in enumerate(tree))
    return fn(path, tree)


def _key(path) -> str:
    return "/".join(path)


def _flatten_with_paths(tree) -> Dict[str, np.ndarray]:
    return {_key(p): _host(leaf) for p, leaf, _ in _walk(tree)}


def _leaf_shape_dtype(leaf) -> Tuple[Tuple[int, ...], Any]:
    """(shape, dtype) of a tensor (real or fake), a ``ShapeDtype``, a numpy
    array, or a host integer (dtype ``int``)."""
    if isinstance(leaf, (torch.Tensor, ShapeDtype, np.ndarray)):
        return tuple(leaf.shape), leaf.dtype
    if isinstance(leaf, (int, np.integer)):
        return (), int
    arr = np.asarray(leaf)
    return tuple(arr.shape), arr.dtype


def _to_leaf(arr: np.ndarray, dtype, device):
    if dtype is int:
        return int(arr)
    if isinstance(dtype, torch.dtype):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device=device, dtype=dtype)
    return np.asarray(arr).astype(dtype)


def _region_shape(region) -> Tuple[int, ...]:
    return tuple(s.stop - s.start for s in region)


def _unflatten_like(skeleton, flat: Dict[str, np.ndarray], *, strict: bool = True,
                    placement: Optional[Placement] = None, regioned: bool = False,
                    device="cpu"):
    """Restore into the structure of ``skeleton`` (the state's whole
    shapes). With a ``placement`` each leaf becomes this rank's slice
    (``flat`` holding the slices already when ``regioned``, else whole
    arrays to cut). ``strict=False`` zero-fills a leaf missing from the
    checkpoint or of another shape (an error-feedback residual stacked over
    another count of batch shards) and lists it in the report."""
    dropped: List[str] = []
    specs = None if placement is None else placement.specs
    if placement is not None:
        device = placement.device

    def leaf_of(path, leaf, spec):
        key = _key(path)
        want_shape, want_dtype = _leaf_shape_dtype(leaf)
        region = (None if placement is None
                  else shard_region(spec, want_shape, placement.mesh))
        arr = flat.get(key)
        if arr is not None and not regioned and tuple(arr.shape) != want_shape:
            if strict:
                raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                                 f"state shape {want_shape}")
            arr = None
        if arr is not None and region is not None and not regioned:
            arr = arr[region]
        if arr is None:
            if strict:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            dropped.append(key)
            arr = np.zeros(want_shape if region is None else _region_shape(region),
                           np.float32 if want_dtype is not int else np.int64)
        return _to_leaf(arr, want_dtype, device)

    leaves = {_key(p): leaf_of(p, leaf, spec) for p, leaf, spec in _walk(skeleton, specs)}
    return _rebuild(skeleton, lambda p, _: leaves[_key(p)]), dropped


def _full_shape(local_shape, spec, sizes) -> Tuple[int, ...]:
    """A slice's whole shape: each sharded dim times its axes' product."""
    out = []
    for dim, entry in zip(local_shape, spec_entries(spec, len(local_shape))):
        prod = 1
        for a in (() if entry is None else _axes_of(entry)):
            prod *= int(sizes.get(a, 1))
        out.append(int(dim) * prod)
    return tuple(out)


def _holds_first(spec, mesh: Mesh, ndim: int) -> bool:
    """Whether this rank is the lowest of those holding its block of a
    tensor under ``spec``: index 0 on every mesh axis the spec leaves out."""
    used = {a for e in spec_entries(spec, ndim) if e is not None for a in _axes_of(e)}
    return all(mesh.index(a) == 0 for a in mesh.axis_names if a not in used)


class _LazyBlocks:
    """coord → block mapping that reads (and checksum-verifies) an npz
    entry only when ``assemble_region`` touches it."""

    def __init__(self, names: Dict[Tuple[int, ...], str], load):
        self._names = names
        self._load = load

    def __getitem__(self, coord: Tuple[int, ...]) -> np.ndarray:
        return self._load(self._names[coord])


def _blocks_whole(arr: np.ndarray, spec, sizes) -> Dict[Tuple[int, ...], np.ndarray]:
    """{grid coordinate: block} of a whole array, sliced positionally."""
    shape = tuple(arr.shape)
    grid = shard_grid(spec, shape, sizes)
    blocks = {}
    for coord in np.ndindex(*grid) if grid else [()]:
        slices = tuple(slice(c * (d // g), (c + 1) * (d // g))
                       for c, d, g in zip(coord, shape, grid))
        blocks[coord] = arr[slices]
    return blocks


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_write=True,
                 fault_hook: Optional[Callable[[str, int], None]] = None):
        """``fault_hook(op, step)`` is called at the start of every payload
        write and may raise: the injected failure takes the path a real I/O
        error would (caught by the write thread, re-raised at ``wait()``,
        classified by the supervisor)."""
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        self.fault_hook = fault_hook
        self._thread: Optional[threading.Thread] = None
        self._write_error: Optional[BaseException] = None
        self._verify_cache: Dict[int, Tuple[Tuple, bool]] = {}
        self.last_restore_report: List[str] = []
        self.last_restore_mode: Optional[str] = None
        self.last_write: Dict[str, float] = {}     # bytes and seconds of the last write
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def write(self, step: int, payload: Dict[str, np.ndarray], meta: Dict) -> None:
        """Write a collected payload (async unless ``async_write`` is off):
        the temp file, ``os.replace``, the sidecar with the CRCs, then GC."""
        def _write():
            t0 = time.perf_counter()
            if self.fault_hook is not None:
                self.fault_hook("write", step)
            tmp = os.path.join(self.dir, f".tmp_ckpt_{step}.npz")
            dst = os.path.join(self.dir, f"ckpt_{step}{_DATA_SUFFIX}")
            side = os.path.join(self.dir, f"ckpt_{step}{_META_SUFFIX}")
            full_meta = {**meta, "checksums": {k: _crc(v) for k, v in payload.items()}}
            with open(tmp, "wb") as f:
                np.savez(f, **payload)
            os.replace(tmp, dst)
            with open(side + ".tmp", "w") as f:
                json.dump(full_meta, f)
            os.replace(side + ".tmp", side)
            self.last_write = {"step": step, "bytes": os.path.getsize(dst),
                               "write_s": time.perf_counter() - t0}
            self._gc()

        def _guarded():
            try:
                _write()
            except BaseException as e:     # surfaces at the next wait()
                self._write_error = e

        if self.async_write:
            self._thread = threading.Thread(target=_guarded, daemon=True)
            self._thread.start()
        else:
            _write()

    def save(self, step: int, state, extra_meta: Optional[dict] = None):
        """Full save: every leaf written whole (host copies taken here)."""
        self.wait()
        flat = _flatten_with_paths(state)
        meta = {"step": int(step), "time": time.time(), "format": FORMAT_FULL,
                **(extra_meta or {})}
        self.write(step, flat, meta)

    def collect_sharded(self, step: int, state, *, mesh, strategy: str, specs,
                        extra_meta: Optional[dict] = None
                        ) -> Optional[Tuple[Dict[str, np.ndarray], Dict]]:
        """(payload, sidecar meta) of a sharded save, on rank 0; None on
        the other ranks. ``mesh``: this rank's ``Mesh`` (``state`` its
        slices; a collective over the mesh's ranks), or an ``{axis: size}``
        mapping (``state`` whole, cut positionally). ``specs``: the spec
        tree the state is placed by, walked beside it."""
        sizes = axis_sizes(mesh)
        is_rank = isinstance(mesh, Mesh)
        payload: Dict[str, np.ndarray] = {}
        spec_json: Dict[str, list] = {}
        for path, leaf, spec in _walk(state, specs):
            key = _key(path)
            spec = () if spec is None else spec
            spec_json[key] = spec_to_json(spec)
            if is_rank:
                local = tuple(_leaf_shape_dtype(leaf)[0])
                if not _holds_first(spec, mesh, len(local)):
                    continue
                full = _full_shape(local, spec, sizes)
                coord = shard_coord(shard_region(spec, full, mesh), full,
                                    shard_grid(spec, full, sizes))
                blocks = {coord: _host(leaf)}
            else:
                blocks = _blocks_whole(_host(leaf), spec, sizes)
            for coord, block in blocks.items():
                payload[f"{key}{_SHARD_SEP}{'_'.join(str(c) for c in coord)}"] = block
        if is_rank and mesh.size > 1:
            # point to point, rank by rank: a gather_object would pad every
            # rank's message to the largest (most ranks hold no first copy)
            import torch.distributed as dist
            group = mesh.group(mesh.axis_names)
            if mesh.rank != 0:
                dist.send_object_list([payload], dst=0, group=group)
                return None
            for r in range(1, mesh.size):
                box = [None]
                dist.recv_object_list(box, src=r, group=group)
                payload.update(box[0])
        meta = {"step": int(step), "time": time.time(), "format": FORMAT_SHARDED,
                "mesh": {str(a): int(s) for a, s in sizes.items()},
                "strategy": str(strategy), "specs": spec_json, **(extra_meta or {})}
        return payload, meta

    def save_sharded(self, step: int, state, *, mesh, strategy: str, specs,
                     extra_meta: Optional[dict] = None):
        """Sharded save (``collect_sharded``, then rank 0 ``write``s)."""
        self.wait()
        collected = self.collect_sharded(step, state, mesh=mesh, strategy=strategy,
                                         specs=specs, extra_meta=extra_meta)
        if collected is not None:
            self.write(step, *collected)

    def wait(self):
        """Join the in-flight write, re-raising its failure (if any): where
        a supervised save's retry policy sees transient I/O errors."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._write_error is not None:
            err, self._write_error = self._write_error, None
            raise err

    # -- restore --------------------------------------------------------------
    def available_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.dir):
            m = _CKPT_RE.match(name)
            if m and os.path.exists(os.path.join(self.dir, name + ".json")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.available_steps()
        return steps[-1] if steps else None

    def read_meta(self, step: int) -> Dict:
        """The JSON sidecar of one checkpoint step."""
        with open(os.path.join(self.dir, f"ckpt_{step}{_META_SUFFIX}")) as f:
            return json.load(f)

    def verify(self, step: int) -> bool:
        """True when the step's payload matches its sidecar (a CRC32 per
        entry; plain decodability where no checksums were recorded), cached
        by (mtime, size)."""
        path = os.path.join(self.dir, f"ckpt_{step}{_DATA_SUFFIX}")
        try:
            st = os.stat(path)
        except OSError:
            return False
        cache_key = (st.st_mtime_ns, st.st_size)
        hit = self._verify_cache.get(step)
        if hit is not None and hit[0] == cache_key:
            return hit[1]
        ok = True
        try:
            sums = self.read_meta(step).get("checksums")
            with np.load(path) as z:
                names = set(z.files)
                if sums is not None:
                    ok = (set(sums) == names
                          and all(_crc(z[n]) == int(sums[n]) for n in names))
                else:
                    for n in names:
                        _ = z[n].shape
        except Exception:
            ok = False
        self._verify_cache[step] = (cache_key, ok)
        return ok

    @staticmethod
    def _check_entry(name: str, arr: np.ndarray,
                     sums: Optional[Dict[str, int]]) -> np.ndarray:
        if sums is not None:
            want = sums.get(name)
            if want is None or _crc(arr) != int(want):
                raise ChecksumError(f"{name}: checksum mismatch")
        return arr

    def _assemble(self, path: str, meta: Dict) -> Dict[str, np.ndarray]:
        """Flat {leaf key: whole host array} from either format, every entry
        read verified against the sidecar."""
        sums = meta.get("checksums")
        with np.load(path) as z:
            if sums is not None and set(sums) - set(z.files):
                raise ChecksumError(
                    f"{path}: entries missing vs sidecar: "
                    f"{sorted(set(sums) - set(z.files))[:4]}")
            raw = {k: self._check_entry(k, z[k], sums) for k in z.files}
        if meta.get("format", FORMAT_FULL) != FORMAT_SHARDED:
            return raw
        mesh, specs = meta["mesh"], meta["specs"]
        grouped: Dict[str, Dict[Tuple[int, ...], np.ndarray]] = {}
        for name, block in raw.items():
            key, _, ck = name.rpartition(_SHARD_SEP)
            coord = tuple(int(c) for c in ck.split("_")) if ck else ()
            grouped.setdefault(key, {})[coord] = block
        flat = {}
        for key, blocks in grouped.items():
            spec = spec_from_json(specs[key])
            grid = tuple(max(c[i] for c in blocks) + 1
                         for i in range(len(next(iter(blocks)))))
            shape = tuple(b * g for b, g in zip(next(iter(blocks.values())).shape, grid))
            # the recorded spec on the recorded mesh must give the file's grid
            if shard_grid(spec, shape, mesh) != grid:
                raise ValueError(f"{key}: sidecar spec {spec} on mesh {mesh} "
                                 f"disagrees with on-disk block grid {grid}")
            flat[key] = assemble_shards(blocks, shape, grid)
        return flat

    def _restore_shard_to_shard(self, path: str, meta: Dict, skeleton,
                                placement: Placement, strict: bool):
        """Sharded checkpoint → this rank's slices, no whole tensor
        assembled: for each leaf whose on-disk grid tiles its whole shape,
        the slice under the target spec is stitched from only the source
        blocks it overlaps (``assemble_region``), each read and verified as
        it is touched; blocks the slice never needs are not read."""
        sums = meta.get("checksums")
        specs, mesh_sizes = meta["specs"], meta["mesh"]
        flat: Dict[str, np.ndarray] = {}
        with np.load(path) as z:
            grouped: Dict[str, Dict[Tuple[int, ...], str]] = {}
            for name in z.files:
                key, _, ck = name.rpartition(_SHARD_SEP)
                coord = tuple(int(c) for c in ck.split("_")) if ck else ()
                grouped.setdefault(key, {})[coord] = name
            loaded: Dict[str, np.ndarray] = {}

            def block(name: str) -> np.ndarray:
                if name not in loaded:
                    loaded[name] = self._check_entry(name, z[name], sums)
                return loaded[name]

            for path_, leaf, tspec in _walk(skeleton, placement.specs):
                key = _key(path_)
                want_shape, _ = _leaf_shape_dtype(leaf)
                coords = grouped.get(key)
                if coords is None or key not in specs:
                    continue                     # missing: strict decides
                spec = spec_from_json(specs[key])
                grid = shard_grid(spec, want_shape, mesh_sizes)
                want_coords = set(np.ndindex(*grid)) if grid else {()}
                block_dims = tuple(d // g for d, g in zip(want_shape, grid))
                if set(coords) != want_coords or tuple(
                        block(coords[next(iter(coords))]).shape) != block_dims:
                    continue                     # on-disk shape != target shape
                region = shard_region(tspec, want_shape, placement.mesh)
                flat[key] = assemble_region(_LazyBlocks(coords, block),
                                            want_shape, grid, region)
        return _unflatten_like(skeleton, flat, strict=strict, placement=placement,
                               regioned=True)

    def restore(self, skeleton, step: Optional[int] = None, *,
                shardings: Optional[Placement] = None, strict: bool = True,
                device="cpu") -> Tuple[Any, int]:
        """Restore into the structure of ``skeleton`` (whole shapes: real or
        fake tensors, ``ShapeDtype``s, host integers); returns (state, step).
        Tries newest first and skips corrupt files.

        Without ``shardings`` every leaf comes back whole on ``device``.
        With a ``Placement`` each comes back as this rank's slice under the
        target specs on the placement's device: across strategies and mesh
        shapes, since the specs come from the same ``param_pspecs``
        resolution the step uses. A ``sharded-v1`` checkpoint goes
        shard-to-shard whenever its grids tile the skeleton's shapes, else
        (and a ``full-v1`` one always) through host assembly;
        ``last_restore_mode`` records which. ``strict=False`` zero-fills
        missing or mismatched leaves (listed in ``last_restore_report``)."""
        self.wait()
        steps = self.available_steps()
        if step is not None:
            steps = [s for s in steps if s == step]
        last_err: Optional[Exception] = None
        for s in reversed(steps):
            path = os.path.join(self.dir, f"ckpt_{s}{_DATA_SUFFIX}")
            try:
                meta = self.read_meta(s)
                state, mode = None, "host-assembly"
                if shardings is not None and meta.get("format") == FORMAT_SHARDED:
                    try:
                        state, dropped = self._restore_shard_to_shard(
                            path, meta, skeleton, shardings, strict)
                        mode = "shard-to-shard"
                    except ChecksumError:
                        raise             # corrupt data: never fall back
                    except Exception:     # structural: the host-assembly path
                        state = None
                if state is None:
                    flat = self._assemble(path, meta)
                    state, dropped = _unflatten_like(skeleton, flat, strict=strict,
                                                     placement=shardings, device=device)
            except Exception as e:        # corrupt or partial: try older
                last_err = e
                continue
            self.last_restore_report = dropped
            self.last_restore_mode = mode
            return state, s
        if last_err is not None:
            raise last_err
        raise FileNotFoundError(f"no checkpoint in {self.dir}")

    # -- gc -------------------------------------------------------------------
    def _gc(self):
        # The keep policy counts only verified checkpoints: a torn or
        # checksum-failing newer write never evicts the last good state.
        # Unverified steps are deleted outright (restore would skip them).
        # If nothing verifies, fall back to the plain newest-N policy.
        steps = self.available_steps()
        if self.keep:
            verified = [s for s in steps if self.verify(s)]
            protect = set(verified[-self.keep:] if verified else steps[-self.keep:])
            for s in steps:
                if s in protect:
                    continue
                for suffix in (_DATA_SUFFIX, _META_SUFFIX):
                    try:
                        os.remove(os.path.join(self.dir, f"ckpt_{s}{suffix}"))
                    except OSError:
                        pass
                self._verify_cache.pop(s, None)
        # orphan temp files and sidecars whose data file is gone
        for name in os.listdir(self.dir):
            full = os.path.join(self.dir, name)
            orphan_tmp = name.startswith(".tmp_ckpt_")
            orphan_side = (name.endswith(_META_SUFFIX)
                           and not os.path.exists(full[:-len(".json")]))
            if orphan_tmp or orphan_side:
                try:
                    os.remove(full)
                except OSError:
                    pass
