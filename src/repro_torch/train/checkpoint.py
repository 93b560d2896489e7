"""Preemption-safe checkpointing, in the reference's on-disk format: flat
.npz files with path-keyed leaves, written atomically (tmp + rename) so a
preemption mid-write never corrupts the last good checkpoint.

Leaves are keyed as JAX's ``keystr`` spells a pytree path — ``['k']`` for
a dict key, ``[i]`` for a sequence item, ``.field`` for a NamedTuple field
— so a file written by either package restores in the other. bf16 leaves
are stored as their uint16 bit patterns and listed under ``__bf16__``
(flat files) or ``bf16_keys`` (sharded manifests); restore casts every
leaf to its template's dtype, so the port's int64 counters and the
reference's int32 ones interchange.

Any tree of tensors persists: a bare ``{"params", "opt"}`` of the legacy
loop or the engine's whole ``SimState`` carry (`trainer.save_batched` /
`restore_batched`). A tensor on the card is copied to the host once per
save, in `_flatten` (`host_snapshot` makes that copy ahead of a deferred
write); restore builds fresh tensors on each template leaf's device."""
from __future__ import annotations

import glob
import json
import os
import queue
import re
import shutil
import tempfile
import threading
import time
import zipfile
import zlib
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

SHARDED_FORMAT = "repro-sharded-checkpoint-v1"

#: reserved keys in a flat .npz checkpoint (everything else is a leaf)
_RESERVED_KEYS = frozenset({"__step__", "__bf16__"})

#: Optional write interposer for fault injection (chaos tests): when set,
#: `_atomic_write` calls ``_write_hook(tmp_path, write_fn)`` instead of
#: ``write_fn(tmp_path)``. The hook may raise (transient-IO faults) or
#: write partially and kill the process (torn-write faults) — the tmp +
#: rename protocol guarantees the destination is never half-written
#: either way. Process-local; never set in production paths.
_write_hook: Optional[Callable[[str, Callable[[str], None]], None]] = None


class CheckpointError(ValueError):
    """A checkpoint on disk is corrupt or incomplete: a sharded manifest
    that is unreadable, malformed, or whose shard files are missing or
    inconsistent. Raised *before* anything is restored — never a silent
    partial restore."""


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _paths(tree, prefix: str = ""):
    """(keystr, leaf) pairs in the order JAX flattens a pytree: dict keys
    sorted, ``None`` an empty subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}[{k!r}]")
    elif _is_namedtuple(tree):
        for name in tree._fields:
            yield from _paths(getattr(tree, name), f"{prefix}.{name}")
    elif isinstance(tree, (tuple, list)):
        for i, x in enumerate(tree):
            yield from _paths(x, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _rebuild(like, leaves: dict, prefix: str = ""):
    """``like``'s structure with the leaf at each keystr taken from
    ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves, f"{prefix}[{k!r}]")
                for k, v in like.items()}
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(getattr(like, n), leaves,
                                     f"{prefix}.{n}") for n in like._fields))
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(x, leaves, f"{prefix}[{i}]")
                          for i, x in enumerate(like))
    return leaves[prefix]


def _to_numpy(leaf, own: bool = False) -> Tuple[np.ndarray, bool]:
    """A leaf as a host numpy array, and whether it holds bf16 bits. With
    ``own`` the array never shares memory with the leaf."""
    if isinstance(leaf, torch.Tensor):
        x = leaf.detach()
        if x.is_cuda:
            x = x.cpu()          # the one device-to-host copy per save
        elif own:
            x = x.clone()
        if x.dtype == torch.bfloat16:
            # numpy has no bf16: keep the bits, as the reference's
            # arr.view(np.uint16) does
            return x.view(torch.int16).numpy().view(np.uint16), True
        return x.numpy(), False
    arr = np.array(leaf, copy=True) if own else np.asarray(leaf)
    if arr.dtype.name == "bfloat16":          # an ml_dtypes leaf
        return arr.view(np.uint16), True
    return arr, False


class HostSnapshot:
    """A tree already flattened to host arrays (`host_snapshot`): what a
    deferred write holds, so that the carry on the card may change while
    the file is written."""

    def __init__(self, flat: dict, bf16_keys: List[str]):
        self.flat = flat
        self.bf16_keys = bf16_keys


def _flatten(tree, own: bool = False) -> Tuple[dict, List[str]]:
    """keystr → np.ndarray, plus the keys holding bfloat16 leaves.

    ``np.savez`` has no bfloat16, so bf16 leaves are stored as their
    uint16 bit patterns and their keys recorded in a side table
    (``__bf16__`` in flat files, ``bf16_keys`` in sharded manifests) so
    restore can view them back losslessly."""
    if isinstance(tree, HostSnapshot):
        return tree.flat, tree.bf16_keys
    flat, bf16_keys = {}, []
    for key, leaf in _paths(tree):
        arr, is_bf16 = _to_numpy(leaf, own)
        if is_bf16:
            bf16_keys.append(key)
        flat[key] = arr
    return flat, bf16_keys


def host_snapshot(tree) -> HostSnapshot:
    """Copy ``tree`` to the host now, for a write that happens later (a
    tensor on the CPU is copied too: the loop updates it in place)."""
    return HostSnapshot(*_flatten(tree, own=True))


def _atomic_write(path: str, write_fn, suffix: str = ".tmp.npz") -> None:
    """Write via tmp + rename in path's directory so a preemption
    mid-write never corrupts an existing file. The tmp name keeps an
    .npz suffix by default because np.savez silently appends one to
    names without it, which would orphan the rename."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=suffix)
    os.close(fd)
    try:
        if _write_hook is not None:
            _write_hook(tmp, write_fn)
        else:
            write_fn(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save(path: str, state: Any, step: int) -> None:
    flat, bf16_keys = _flatten(state)
    flat = dict(flat, __step__=np.asarray(step))
    if bf16_keys:
        flat["__bf16__"] = np.asarray(sorted(bf16_keys))
    _atomic_write(path, lambda tmp: np.savez(tmp, **flat))


def restore(path: str, like: Any) -> Tuple[Any, int]:
    """Restore into the structure of `like` (values replaced by saved
    arrays, cast to each template leaf's dtype and placed on its device;
    Python-scalar leaves come back as Python scalars of the same type).

    Structure drift between the checkpoint and the template — keys present
    in one but not the other — raises a ValueError naming the offending
    keys. A file that cannot be read as an .npz at all (truncated by a
    torn write, not a zip) raises `CheckpointError` naming the path."""
    try:
        with np.load(path) as data:
            if "__step__" not in data:
                raise ValueError(f"{path} is not a repro checkpoint "
                                 "(missing __step__)")
            step = int(data["__step__"])
            bf16 = frozenset(data["__bf16__"].tolist()) \
                if "__bf16__" in data else frozenset()
            tree = _fill_template(data, set(data.files) - _RESERVED_KEYS,
                                  path, like, bf16_keys=bf16)
    except (zipfile.BadZipFile, zlib.error, EOFError, OSError) as e:
        raise CheckpointError(
            f"{path} is not a readable checkpoint: {e}") from e
    return tree, step


def _leaf_like(arr: np.ndarray, leaf, is_bf16: bool):
    """One saved array as a leaf of the template's kind, dtype and device."""
    if isinstance(leaf, (bool, int, float)):
        # a Python-scalar template leaf: the same Python type back
        return type(leaf)(arr.item())
    if isinstance(leaf, torch.Tensor):
        if is_bf16:
            t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                 ).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.ascontiguousarray(arr))
        # a fresh, contiguous allocation on the template's device
        return t.to(device=leaf.device, dtype=leaf.dtype, copy=True)
    if hasattr(leaf, "dtype"):
        if is_bf16:
            raise ValueError("a bf16 leaf restores into a torch template "
                             "leaf only (numpy has no bfloat16)")
        return np.asarray(arr, dtype=leaf.dtype)
    return arr


def _fill_template(data, have: set, path: str, like: Any,
                   bf16_keys: frozenset = frozenset()) -> Any:
    """Rebuild `like`'s structure from a mapping of keystr → array.

    `data` is anything indexable by key (an open NpzFile or a dict);
    `have` is the set of leaf keys it holds; keys in ``bf16_keys`` hold
    uint16 bit patterns of bfloat16 leaves (see `_flatten`). Raises
    ValueError naming missing/extra keys on structure drift."""
    pairs = list(_paths(like))
    keys = [k for k, _ in pairs]
    missing = [k for k in keys if k not in have]
    extra = sorted(have - set(keys))
    if missing or extra:
        raise ValueError(
            f"checkpoint {path} does not match the restore template: "
            f"{len(missing)} template leaves missing from the "
            f"checkpoint {missing[:4]}{'...' if len(missing) > 4 else ''}"
            f", {len(extra)} checkpoint keys with no template leaf "
            f"{extra[:4]}{'...' if len(extra) > 4 else ''}")
    return _rebuild(like, {k: _leaf_like(data[k], leaf, k in bf16_keys)
                           for k, leaf in pairs})


# --------------------------------------------------------------------------
# Sharded checkpoints: per-shard .npz files + a JSON index manifest
# --------------------------------------------------------------------------


def _shard_file(path: str, step: int, i: int, n: int) -> str:
    return f"{path}.t{step}.shard{i:02d}-of-{n:02d}.npz"


def save_sharded(path: str, state: Any, step: int, n_shards: int) -> None:
    """Split every leaf of `state` along its leading axis into `n_shards`
    per-shard .npz files next to `path`, then write `path` itself as a
    JSON manifest indexing them.

    The manifest is written (atomically) *last*, so a preemption
    mid-save leaves the previous manifest — and the complete shard set
    it references — intact; the new shard files are step-tagged and
    never collide with the old ones. Stale shard files from earlier
    steps are pruned after the manifest lands.

    Every leaf must share the same leading-axis length (true of the
    engine's (S, R, ...) `SimState` carry, sharded by scenario). The
    manifest records per-shard row counts, so reassembly is exact."""
    flat, bf16_keys = _flatten(state)
    if not flat:
        raise ValueError("cannot shard an empty pytree")
    rows = {v.shape[0] if v.ndim else None for v in flat.values()}
    if len(rows) != 1 or None in rows:
        raise ValueError(
            "sharded save needs every leaf to share one leading-axis "
            f"length; got leading sizes {sorted(map(str, rows))}")
    n_rows = rows.pop()
    n_shards = max(1, min(int(n_shards), n_rows))
    bounds = np.cumsum([0] + [len(c) for c in
                              np.array_split(np.arange(n_rows), n_shards)])
    shards = []
    for i in range(n_shards):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        fname = _shard_file(path, step, i, n_shards)
        _atomic_write(fname, lambda tmp, lo=lo, hi=hi: np.savez(
            tmp, **{k: v[lo:hi] for k, v in flat.items()}))
        shards.append({"file": os.path.basename(fname), "rows": hi - lo})
    manifest = {"format": SHARDED_FORMAT, "step": int(step),
                "n_shards": n_shards, "rows": int(n_rows),
                "keys": sorted(flat), "shards": shards,
                "bf16_keys": sorted(bf16_keys)}

    def write_manifest(tmp):
        with open(tmp, "w") as f:
            f.write(json.dumps(manifest, indent=1))

    _atomic_write(path, write_manifest, suffix=".tmp.json")
    current = {s["file"] for s in shards}
    for old in glob.glob(glob.escape(path) + ".t*.shard*.npz"):
        if os.path.basename(old) not in current:
            os.unlink(old)


def restore_sharded(path: str, like: Any) -> Tuple[Any, int]:
    """Reassemble a `save_sharded` checkpoint into `like`'s structure.

    Any corruption — unreadable/malformed manifest, wrong format tag,
    missing shard file, shard whose row count disagrees with the
    manifest — raises `CheckpointError` naming the cause before any
    state is returned."""
    try:
        with open(path) as f:
            manifest = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CheckpointError(
            f"{path} is not a readable sharded-checkpoint manifest: {e}")
    if not isinstance(manifest, dict) or \
            manifest.get("format") != SHARDED_FORMAT:
        got = manifest.get("format") if isinstance(manifest, dict) \
            else type(manifest).__name__
        raise CheckpointError(
            f"{path} is not a {SHARDED_FORMAT} manifest (format={got!r})")
    for field in ("step", "n_shards", "rows", "keys", "shards"):
        if field not in manifest:
            raise CheckpointError(
                f"manifest {path} is missing required field '{field}'")
    shards = manifest["shards"]
    if len(shards) != manifest["n_shards"]:
        raise CheckpointError(
            f"manifest {path} lists {len(shards)} shards but declares "
            f"n_shards={manifest['n_shards']}")
    base = os.path.dirname(os.path.abspath(path))
    keys = manifest["keys"]
    parts = {k: [] for k in keys}
    for i, entry in enumerate(shards):
        fname = os.path.join(base, entry["file"])
        if not os.path.exists(fname):
            raise CheckpointError(
                f"shard {i} of checkpoint {path} is missing: "
                f"{entry['file']} not found — refusing a partial restore")
        try:
            data_cm = np.load(fname)
        except (zipfile.BadZipFile, zlib.error, EOFError, OSError) as e:
            raise CheckpointError(
                f"shard {i} ({entry['file']}) of checkpoint {path} is "
                f"unreadable: {e}") from e
        with data_cm as data:
            got = set(data.files)
            if got != set(keys):
                raise CheckpointError(
                    f"shard {i} ({entry['file']}) keys disagree with the "
                    f"manifest: missing {sorted(set(keys) - got)[:4]}, "
                    f"unexpected {sorted(got - set(keys))[:4]}")
            for k in keys:
                arr = data[k]
                if arr.shape[0] != entry["rows"]:
                    raise CheckpointError(
                        f"shard {i} ({entry['file']}) has {arr.shape[0]} "
                        f"rows of '{k}' but the manifest promised "
                        f"{entry['rows']}")
                parts[k].append(arr)
    full = {k: np.concatenate(parts[k], axis=0) if len(parts[k]) > 1
            else parts[k][0] for k in keys}
    if keys and next(iter(full.values())).shape[0] != manifest["rows"]:
        raise CheckpointError(
            f"checkpoint {path} reassembles to "
            f"{next(iter(full.values())).shape[0]} rows but the manifest "
            f"promised {manifest['rows']}")
    tree = _fill_template(full, set(keys), path, like,
                          bf16_keys=frozenset(manifest.get("bf16_keys",
                                                           ())))
    return tree, int(manifest["step"])


def restore_any(path: str, like: Any) -> Tuple[Any, int]:
    """Restore either checkpoint format: a flat .npz (`save`) or a
    sharded manifest (`save_sharded`), sniffed from the file's first
    bytes (npz is a zip: 'PK'; the manifest is JSON: '{')."""
    with open(path, "rb") as f:
        head = f.read(2)
    if head[:1] == b"{":
        return restore_sharded(path, like)
    return restore(path, like)


# --------------------------------------------------------------------------
# Step directories: one subdirectory per checkpointed tick, with retention,
# corruption fallback and quarantine — the layout the self-healing
# supervisor (launch/supervisor.py) resumes from
# --------------------------------------------------------------------------

_STEP_RE = re.compile(r"^step_(\d{8})$")
QUARANTINE_DIRNAME = "quarantine"


def step_dir(root: str, tick: int) -> str:
    return os.path.join(root, f"step_{int(tick):08d}")


def step_path(root: str, tick: int) -> str:
    """The checkpoint file (flat .npz or sharded manifest) of one step."""
    return os.path.join(step_dir(root, tick), "ckpt")


def list_steps(root: str) -> List[int]:
    """Ticks of the *complete* steps under `root`, ascending.

    A step counts as complete only if its `ckpt` file exists — the file is
    written last and atomically, so a step directory killed mid-save (only
    shard files and/or `.tmp` leftovers inside) is invisible here and can
    never shadow an older valid checkpoint."""
    if not os.path.isdir(root):
        return []
    ticks = []
    for name in os.listdir(root):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(root, name, "ckpt")):
            ticks.append(int(m.group(1)))
    return sorted(ticks)


def save_step(root: str, state: Any, tick: int,
              n_shards: Optional[int] = None,
              keep_last: Optional[int] = None) -> str:
    """Persist `state` as `root/step_<tick>/ckpt` (sharded when
    `n_shards`). Stale ``.tmp`` leftovers from an earlier killed save of
    the same step are swept first; with ``keep_last`` the oldest steps
    beyond the n newest are deleted after the write lands. Returns the
    checkpoint path."""
    d = step_dir(root, tick)
    os.makedirs(d, exist_ok=True)
    for stale in glob.glob(os.path.join(glob.escape(d), "*.tmp*")):
        os.unlink(stale)
    path = step_path(root, tick)
    if n_shards:
        save_sharded(path, state, tick, n_shards)
    else:
        save(path, state, tick)
    if keep_last:
        prune_steps(root, keep_last)
    return path


def prune_steps(root: str, keep_last: int) -> List[int]:
    """Delete all but the newest `keep_last` complete steps (and any
    incomplete step directories older than the oldest kept tick).
    Quarantined steps are never touched. Returns the removed ticks."""
    if keep_last < 1:
        raise ValueError(f"keep_last={keep_last} must be >= 1")
    ticks = list_steps(root)
    drop = ticks[:-keep_last] if len(ticks) > keep_last else []
    for tick in drop:
        shutil.rmtree(step_dir(root, tick), ignore_errors=True)
    if ticks:
        oldest_kept = ticks[-keep_last] if len(ticks) >= keep_last else \
            ticks[0]
        for name in os.listdir(root):
            m = _STEP_RE.match(name)
            if m and int(m.group(1)) < oldest_kept and \
                    not os.path.exists(os.path.join(root, name, "ckpt")):
                shutil.rmtree(os.path.join(root, name), ignore_errors=True)
    return drop


def quarantine_step(root: str, tick: int, reason: str = "") -> str:
    """Move a corrupt step directory into `root/quarantine/` (never
    deleted by GC, never considered by `list_steps`/`restore_newest`) and
    record why. Returns the quarantine location."""
    qroot = os.path.join(root, QUARANTINE_DIRNAME)
    os.makedirs(qroot, exist_ok=True)
    src = step_dir(root, tick)
    dst = os.path.join(qroot, os.path.basename(src))
    n = 0
    while os.path.exists(dst):
        n += 1
        dst = os.path.join(qroot, f"{os.path.basename(src)}.{n}")
    os.replace(src, dst)
    with open(os.path.join(dst, "REASON.txt"), "w") as f:
        f.write(reason or "corrupt checkpoint (unspecified)")
    return dst


def restore_newest(root: str, like: Any, strict: bool = True
                   ) -> Tuple[Any, int, str]:
    """Restore the newest valid step under `root` into `like`'s structure.
    Returns ``(state, tick, path)`` — the tick actually used, which with
    ``strict=False`` may be older than the newest on disk.

    ``strict=True``: the newest complete step must restore cleanly, or a
    `CheckpointError` propagates. ``strict=False``: a corrupt newest step
    (truncated shard, torn manifest, template drift — anything
    `restore_any` rejects) is *quarantined* and the previous step is
    tried, falling back until a valid one restores; only when every step
    is corrupt (or none exists) does it raise."""
    ticks = list_steps(root)
    if not ticks:
        raise CheckpointError(f"no complete checkpoint steps under {root}")
    errors = []
    for tick in reversed(ticks):
        path = step_path(root, tick)
        try:
            state, step = restore_any(path, like)
            return state, step, path
        except Exception as e:  # noqa: BLE001 — every failure mode of a
            # corrupt file (CheckpointError, zipfile/np.load errors,
            # template-drift ValueError) means "this step is unusable"
            if strict:
                raise CheckpointError(
                    f"newest checkpoint step {tick} under {root} is "
                    f"corrupt: {e}") from e
            errors.append(f"step {tick}: {e}")
            quarantine_step(root, tick, reason=str(e))
    raise CheckpointError(
        f"every checkpoint step under {root} is corrupt: "
        f"{'; '.join(errors)}")


# --------------------------------------------------------------------------
# Retries and the background writer
# --------------------------------------------------------------------------


def retry_io(fn: Callable, *args, retries: int = 3, backoff: float = 0.05,
             sleep: Callable[[float], None] = time.sleep):
    """Call ``fn(*args)``, retrying *transient* failures (`OSError`:
    disk-full, EIO, a flaky network mount) up to `retries` times with
    exponential backoff (``backoff * 2**attempt`` seconds). Anything
    other than `OSError` — including `CheckpointError` — propagates
    immediately."""
    for attempt in range(retries + 1):
        try:
            return fn(*args)
        except OSError:
            if attempt == retries:
                raise
            sleep(backoff * (2 ** attempt))


class AsyncCheckpointWriter:
    """Serializes checkpoints on a background thread so the training loop
    never waits on disk I/O.

    `submit(...)` copies the state to the host (`host_snapshot`) and
    returns: the carry on the card is updated in place by the next chunk,
    so the writer must own its copy before the caller goes on. Saves are
    written in submission order by a single daemon thread; `wait()`
    blocks until the queue drains. A failed save is never silently
    dropped: the deferred error re-raises from the next `submit`/`wait`,
    and from `close()`/`__exit__`, which always drain the queue and
    re-check before returning. Usable as a context manager.

    Transient I/O errors (`OSError`) are retried up to `retries` times
    with exponential backoff (`backoff * 2**attempt` seconds) before the
    error is recorded for re-raise. Non-OSError failures are never
    retried."""

    def __init__(self, retries: int = 3, backoff: float = 0.05):
        self.retries = int(retries)
        self.backoff = float(backoff)
        self._q: queue.Queue = queue.Queue()
        self._error: Optional[BaseException] = None
        self._sleep = time.sleep          # injectable for tests
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                fn, args = item
                if self._error is None:
                    retry_io(fn, *args, retries=self.retries,
                             backoff=self.backoff, sleep=self._sleep)
            except BaseException as e:  # noqa: BLE001 — deferred re-raise
                self._error = e
            finally:
                self._q.task_done()

    def _check(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def submit(self, path: str, state: Any, step: int,
               n_shards: Optional[int] = None) -> None:
        """Copy `state` to the host and enqueue its save (sharded when
        `n_shards`); returns without waiting for the write."""
        self._check()
        snap = host_snapshot(state)
        if n_shards:
            self._q.put((save_sharded, (path, snap, step, n_shards)))
        else:
            self._q.put((save, (path, snap, step)))

    def submit_step(self, root: str, state: Any, tick: int,
                    n_shards: Optional[int] = None,
                    keep_last: Optional[int] = None) -> None:
        """Copy `state` to the host and enqueue a step-directory save
        (`save_step`, including its `keep_last` GC)."""
        self._check()
        self._q.put((save_step, (root, host_snapshot(state), tick,
                                 n_shards, keep_last)))

    def wait(self) -> None:
        """Block until every submitted save has hit disk."""
        self._q.join()
        self._check()

    def close(self) -> None:
        """Drain the queue, stop the thread, and re-raise any deferred
        save error — including one raised by the final submitted save.
        Idempotent."""
        if self._thread.is_alive():
            self._q.join()
            self._q.put(None)
            self._thread.join()
        self._check()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
