"""Checkpointing for fault tolerance.

PyTorch port of ``repro.checkpoint.ckpt``; a directory written by either
package loads in the other:

  * Layout: one ``step_%010d/`` directory per step, one ``shard_{pid}.npz``
    per host (keys are tree paths with ``"\\x1f"`` for ``/``) and a
    ``manifest.json`` (keys, shapes, logical dtypes, a crc32 per stored
    array, and the caller's json-serializable ``extra``).
  * Atomicity: write into ``<dir>.tmp`` then ``os.replace``; a crash
    mid-save never corrupts the latest checkpoint, and a restore picks the
    newest committed step that passes its crc32 checks.
  * Async: ``CheckpointManager.save(..., blocking=False)`` snapshots the
    leaves to host memory, then writes from a worker thread; ``wait()``
    joins it (one save in flight).

Leaves are torch tensors (saved from ``.detach().cpu()``) or numpy arrays,
inside dicts, lists, tuples and NamedTuples. A ``torch.bfloat16`` leaf is
stored as its 16-bit pattern with logical dtype ``"bfloat16"`` in the
manifest — what ``repro`` writes for an ``ml_dtypes`` bfloat16 array — and
loads back as a ``torch.bfloat16`` tensor. ``load_checkpoint`` returns
numpy leaves (bfloat16 ones as CPU tensors: numpy has no such dtype), or
tensors on ``device`` when one is given.

A sharded filter state (stacked ``[S, ...]`` leaves) saves and loads like
any other. ``repro``'s ``load_checkpoint(shardings=...)`` is a
``device_put`` of the loaded leaves onto a mesh; the port keeps all
shards on one device, so ``device=`` is its counterpart. The elastic
part of a restore onto another shard count is the session's
(``FilterSession.restore_state``), not this module's.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import pathlib
import shutil
import threading
import zlib

import numpy as np
import torch

log = logging.getLogger(__name__)

#: torch dtypes with no numpy counterpart, stored as their bit pattern
_BIT_VIEWS = {torch.bfloat16: torch.int16}


def _flatten(tree, prefix=""):
    """Flatten a tree to {path: leaf} with stable, readable keys."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif hasattr(tree, "_fields"):               # NamedTuple
        for k in tree._fields:
            out.update(_flatten(getattr(tree, k), f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten_like(template, flat, prefix=""):
    if isinstance(template, dict):
        return {k: _unflatten_like(template[k], flat, f"{prefix}{k}/")
                for k in template}
    if hasattr(template, "_fields"):
        return type(template)(*[
            _unflatten_like(getattr(template, k), flat, f"{prefix}{k}/")
            for k in template._fields])
    if isinstance(template, (list, tuple)):
        return type(template)(
            _unflatten_like(v, flat, f"{prefix}{i}/")
            for i, v in enumerate(template))
    return flat[prefix[:-1]]


def _map_leaves(fn, tree):
    """``tree`` with every leaf replaced by ``fn(leaf)``, structure kept."""
    flat = {k: fn(v) for k, v in _flatten(tree).items()}
    return _unflatten_like(tree, flat)


def _host_leaf(v, *, copy: bool = False):
    """A leaf as a host value: numpy, or a CPU tensor for bit-view dtypes."""
    if isinstance(v, torch.Tensor):
        t = v.detach().to("cpu", copy=copy)
        return t if t.dtype in _BIT_VIEWS else t.numpy()
    return np.array(v, copy=copy) if copy else np.asarray(v)


def _encode(v) -> tuple[np.ndarray, str, list]:
    """(stored array, logical dtype, logical shape) of one host leaf."""
    if isinstance(v, torch.Tensor):                # a bit-view dtype
        bits = v.contiguous().view(_BIT_VIEWS[v.dtype]).numpy()
        return (bits.view(np.dtype(f"u{bits.itemsize}")),
                str(v.dtype).removeprefix("torch."), list(v.shape))
    stored = v
    # numpy can't serialize ml_dtypes (bfloat16, fp8): store raw bit views
    # and record the logical dtype in the manifest
    if v.dtype.kind == "V" or v.dtype.name not in np.sctypeDict:
        stored = v.view(np.uint16 if v.dtype.itemsize == 2 else np.uint8)
    return stored, str(v.dtype), list(v.shape)


def save_checkpoint(directory, step: int, tree, *, extra: dict | None = None,
                    process_id: int = 0) -> pathlib.Path:
    """Atomic blocking save of ``tree`` (+ json-serializable ``extra``)."""
    directory = pathlib.Path(directory)
    final = directory / f"step_{step:010d}"
    tmp = directory / f"step_{step:010d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    flat = {k: _encode(_host_leaf(v)) for k, v in _flatten(tree).items()}
    encoded = {k: e[0] for k, e in flat.items()}
    np.savez(tmp / f"shard_{process_id}.npz",
             **{k.replace("/", "\x1f"): v for k, v in encoded.items()})
    manifest = {
        "step": step,
        "keys": sorted(flat),
        "shapes": {k: e[2] for k, e in flat.items()},
        "dtypes": {k: e[1] for k, e in flat.items()},
        # per-array crc32 of the STORED bytes (what storage can rot): a
        # restore verifies these before deserializing, and the newest-valid
        # fallback in load_checkpoint skips steps that fail
        "crc32": {k: zlib.crc32(
            np.ascontiguousarray(v).tobytes()) for k, v in encoded.items()},
        "extra": extra or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)                      # commit point
    return final


def _committed_steps(directory: pathlib.Path) -> list[int]:
    if not directory.exists():
        return []
    return sorted(int(p.name.split("_")[1]) for p in directory.iterdir()
                  if p.is_dir() and p.name.startswith("step_")
                  and not p.name.endswith(".tmp")
                  and (p / "manifest.json").exists())


def latest_step(directory) -> int | None:
    steps = _committed_steps(pathlib.Path(directory))
    return steps[-1] if steps else None


def _decode(stored: np.ndarray, want: str, device):
    """One stored array → its leaf: numpy, or a tensor on ``device``."""
    if str(stored.dtype) != want:               # a bit view
        dtype = getattr(torch, want, None)
        if not isinstance(dtype, torch.dtype):
            raise ValueError(f"cannot load logical dtype {want!r} without "
                             "ml_dtypes")
        bits = stored.view(np.dtype(f"i{stored.itemsize}"))
        t = torch.from_numpy(bits).view(dtype)
        return t if device is None else t.to(device)
    return stored if device is None else torch.from_numpy(stored).to(device)


def _load_one(path: pathlib.Path, template, process_id: int, device):
    manifest = json.loads((path / "manifest.json").read_text())
    with np.load(path / f"shard_{process_id}.npz") as z:
        flat = {k.replace("\x1f", "/"): z[k] for k in z.files}
    crcs = manifest.get("crc32", {})
    for k, want in crcs.items():
        if k not in flat:
            raise ValueError(f"corrupt checkpoint {path.name}: array {k!r} "
                             "listed in the manifest is missing")
        got = zlib.crc32(np.ascontiguousarray(flat[k]).tobytes())
        if got != int(want):
            raise ValueError(
                f"corrupt checkpoint {path.name}: crc32 mismatch on {k!r} "
                f"(stored {int(want):#010x}, computed {got:#010x}) — the "
                "blob was truncated or bit-flipped in storage")
    dtypes = manifest["dtypes"]
    flat = {k: _decode(v, dtypes.get(k, str(v.dtype)), device)
            for k, v in flat.items()}
    return _unflatten_like(template, flat), manifest["extra"]


def load_checkpoint(directory, template, *, step: int | None = None,
                    device=None, process_id: int = 0):
    """Restore into the structure of ``template``; returns (tree, extra,
    step). Leaves are numpy arrays, or tensors on ``device`` when given.

    Integrity: every array's crc32 is verified before deserializing. With
    ``step=None`` the restore walks committed steps NEWEST-FIRST and falls
    back past corrupted/truncated ones (each skip logged), raising only
    when no step loads cleanly; an explicit ``step`` fails hard instead.
    Pre-crc manifests (no ``crc32`` field) load unverified.
    """
    directory = pathlib.Path(directory)
    if step is not None:
        candidates = [step]
    else:
        candidates = list(reversed(_committed_steps(directory)))
        if not candidates:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    last_err: Exception | None = None
    for s in candidates:
        path = directory / f"step_{s:010d}"
        try:
            tree, extra = _load_one(path, template, process_id, device)
        except (ValueError, OSError, KeyError) as e:
            if step is not None:
                raise
            log.warning("checkpoint %s is corrupt (%s); falling back to "
                        "the previous committed step", path.name, e)
            last_err = e
            continue
        return tree, extra, s
    raise ValueError(
        f"every committed checkpoint in {directory} failed integrity "
        f"verification; newest error: {last_err}")


@dataclasses.dataclass
class CheckpointManager:
    """Keeps the last ``keep`` checkpoints; optional async saves."""

    directory: str
    keep: int = 3
    _worker: threading.Thread | None = None

    def wait(self):
        if self._worker is not None:
            self._worker.join()
            self._worker = None

    def save(self, step: int, tree, *, extra=None, blocking=True):
        self.wait()
        # snapshot before async: later writes to the caller's leaves must
        # not reach the file
        host_tree = _map_leaves(lambda v: _host_leaf(v, copy=True), tree)

        def do():
            save_checkpoint(self.directory, step, host_tree, extra=extra)
            self._gc()

        if blocking:
            do()
        else:
            self._worker = threading.Thread(target=do, daemon=True)
            self._worker.start()

    def restore(self, template, *, step=None, device=None):
        return load_checkpoint(self.directory, template, step=step,
                               device=device)

    def _gc(self):
        d = pathlib.Path(self.directory)
        steps = sorted(int(p.name.split("_")[1]) for p in d.iterdir()
                       if p.is_dir() and p.name.startswith("step_")
                       and not p.name.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(d / f"step_{s:010d}", ignore_errors=True)
