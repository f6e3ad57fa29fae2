"""The fused filter-chain, gather and tile-stats kernels: build, launch,
plain twins.

Counterpart of ``repro.kernels.filter_chain.filter_chain`` (the Pallas
kernels ``_kernel`` with and without skip decisions, ``_gather_kernel``
and ``_stats_kernel``). The kernels are CUDA C++ for
``sm_90a`` in ``csrc/filter_chain.cu`` with a plain C interface; this
module compiles that file with ``nvcc`` on first use into
``build/repro_torch_kernels/`` at the checkout root and binds it with
``ctypes``.

Each kernel has a wrapper and a twin:

  * the wrapper (``filter_chain_kernel``, ``compact_gather_kernel``,
    ``tile_stats_kernel``) launches the kernel on a CUDA tensor, on
    PyTorch's current stream, and counts the launch in its ``launches``
    attribute (``filter_chain_kernel.skip_launches`` also counts its
    launches with skip decisions); on a CPU tensor it runs the twin
    instead, and on any other device it raises;
  * the twin (``filter_chain_twin``, ``compact_gather_twin``,
    ``tile_stats_twin``) is plain
    PyTorch with the kernel's exact contract — the same tile split, the
    same per-tile counters, the same in-tile pack — written over a
    ``[C, T, tile]`` view of the padded batch, so it runs at full width on
    either device. Nothing on the main path calls a twin for a CUDA tensor.

A failed build (no ``nvcc``, a compile error, a library that does not
load) and a launch that returns a CUDA error raise ``KernelError``, a
``RuntimeError`` that no retry can cure. A wrapper that refuses to launch
(more than ``MAX_PREDS`` predicates, a misaligned column, a wrong device,
dtype or shape) raises ``KernelRefusal``, a ``KernelError`` that is also a
``ValueError``. The guarded runtime (``repro_torch.runtime.guard``)
re-raises both rather than retrying the step or degrading to the ``torch``
engine, which would hide a kernel that does not run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from repro_torch.core import predicates as pred_lib

DEFAULT_TILE = 2048     # logical rows per tile (= one CTA); the only tile
                        # the kernels are built for (kTile in the source)
MAX_PREDS = 32          # the kernel keeps predicate sets in 32-bit masks
STAT_TILE = 128         # rows per zone-map sub-tile (kStatTile)

SOURCE = Path(__file__).resolve().parent / "csrc" / "filter_chain.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def build_dir() -> Path:
    """``build/repro_torch_kernels`` at the root of the checkout."""
    return Path(__file__).resolve().parents[4] / "build" / "repro_torch_kernels"


class KernelError(RuntimeError):
    """The kernel library did not build or load, or a launch returned a
    CUDA error: a fault of the build or the device, never transient."""


class KernelRefusal(KernelError, ValueError):
    """A wrapper refused to launch: its inputs break the kernel's
    contract. The same plan and inputs are refused again on any retry."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelError("nvcc not found: the CUDA kernels of repro_torch are "
                      "built with the CUDA toolkit's nvcc")


class _Library:
    """The compiled shared library, its ctypes signatures and build log."""

    def __init__(self, path: Path, log: str):
        self.path = path
        self.log = log
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise KernelError(f"cannot load the kernel library {path}: "
                              f"{e}") from e
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        f32 = ctypes.c_float
        lib.filter_chain_launch.argtypes = [
            ptr, i32, i64, i32, i32,                 # cols, C, stride, T, tile
            ptr, ptr, ptr, ptr, ptr, ptr, ptr,       # specs, perm, groups
            i32, i32, ptr,                           # P, G, meta
            ptr, ptr, ptr, ptr, ptr, ptr, ptr,       # outputs
            f32, ptr, ptr, ptr]                      # fill, pass, fail,
                                                     # stream
        lib.filter_chain_launch.restype = i32
        lib.tile_stats_launch.argtypes = [ptr, i64, ptr, ptr, ptr]
        lib.tile_stats_launch.restype = i32
        lib.compact_gather_launch.argtypes = [
            ptr, i32, i64, i32, i32, ptr, ptr, i32, f32, ptr, ptr]
        lib.compact_gather_launch.restype = i32
        self.lib = lib


_LIBRARY: _Library | None = None


def build() -> _Library:
    """Compile (once per source content) and load the kernel library.

    The library name carries a hash of the source, so an edited source is
    rebuilt; the compile goes to a temporary file that is renamed into
    place, so concurrent builds never load a half-written library.
    ``log`` holds nvcc's output, including ``-Xptxas -v``'s registers,
    shared memory and spills per kernel.
    """
    global _LIBRARY
    if _LIBRARY is not None:
        return _LIBRARY
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"libfilter_chain-{digest[:12]}.so"
    log_path = so.with_suffix(".log")
    if not so.exists():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        if proc.returncode != 0:
            os.unlink(tmp)
            raise KernelError(f"nvcc failed ({proc.returncode}):\n{log}")
        log_path.write_text(log)
        os.replace(tmp, so)
    log = log_path.read_text() if log_path.exists() else ""
    _LIBRARY = _Library(so, log)
    return _LIBRARY


def _check_cuda(name: str, t: torch.Tensor, dtype, device) -> None:
    if t.device != device:
        raise KernelRefusal(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise KernelRefusal(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise KernelRefusal(f"{name} must be contiguous")


def _check_launch(name: str, err: int) -> None:
    """The launch-status check: a nonzero CUDA error code from a launch
    entry point raises ``KernelError``."""
    if err:
        raise KernelError(f"{name} kernel launch failed: CUDA error {err}")


def _stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ================================================================ chain
def filter_chain_kernel(columns: torch.Tensor, specs, perm: torch.Tensor,
                        meta: torch.Tensor, *, compact: bool = False,
                        fill: float = 0.0, skip_decisions=None):
    """Fused CNF chain over padded f32[C, Rp] (Rp % DEFAULT_TILE == 0).

    ``meta`` is i32[4] = (n_rows, collect_rate, sample_phase, mode) on the
    columns' device; ``perm`` i32[P]. Returns (mask i8[1, Rp], active
    f32[T, P], cut f32[T, P], gcut f32[T, G], nmon f32[T, 1]) and, with
    ``compact=True``, also (packed f32[C, Rp], cnt i32[T, 1]) — the
    contract of ``filter_chain_pallas``. ``skip_decisions`` is None or
    (pass i32[Rp/128], fail i32[Rp/128]) from the zone-map triage: rows of
    a sub-tile with a flag > 0 start non-pending, and valid rows of pass
    sub-tiles survive.
    """
    n_preds, n_groups = specs.n, specs.n_groups
    if n_preds > MAX_PREDS:      # the twin holds the kernel's limit too
        raise KernelRefusal(f"at most {MAX_PREDS} predicates, got "
                            f"{n_preds}")
    dev = columns.device
    if dev.type == "cpu":
        return filter_chain_twin(columns, specs, perm, meta,
                                 compact=compact, fill=fill,
                                 skip_decisions=skip_decisions)
    if dev.type != "cuda":
        raise KernelRefusal(f"filter_chain_kernel: unsupported device {dev}")
    n_cols, n_rows_p = columns.shape
    tile = DEFAULT_TILE
    if n_rows_p == 0 or n_rows_p % tile:
        raise KernelRefusal(f"padded rows {n_rows_p} not a positive multiple "
                            f"of tile {tile}")
    _check_cuda("columns", columns, torch.float32, dev)
    if columns.data_ptr() % 16:
        raise KernelRefusal("columns must be 16-byte aligned")
    for name in ("column", "op", "rounds", "group_ids"):
        _check_cuda(name, getattr(specs, name), torch.int32, dev)
    for name in ("t1", "t2"):
        _check_cuda(name, getattr(specs, name), torch.float32, dev)
    _check_cuda("perm", perm, torch.int32, dev)
    _check_cuda("meta", meta, torch.int32, dev)
    if perm.shape != (n_preds,) or meta.shape != (4,):
        raise KernelRefusal("perm must be i32[P] and meta i32[4]")
    pass_ptr = fail_ptr = None
    if skip_decisions is not None:
        for name, d in zip(("pass", "fail"), skip_decisions):
            _check_cuda(name, d, torch.int32, dev)
            if d.shape != (n_rows_p // STAT_TILE,):
                raise KernelRefusal(f"{name} decisions must be i32[Rp/"
                                    f"{STAT_TILE}]")
        pass_ptr = skip_decisions[0].data_ptr()
        fail_ptr = skip_decisions[1].data_ptr()

    n_tiles = n_rows_p // tile
    mask = torch.empty((1, n_rows_p), dtype=torch.int8, device=dev)
    active = torch.empty((n_tiles, n_preds), dtype=torch.float32, device=dev)
    cut = torch.empty((n_tiles, n_preds), dtype=torch.float32, device=dev)
    gcut = torch.empty((n_tiles, n_groups), dtype=torch.float32, device=dev)
    nmon = torch.empty((n_tiles, 1), dtype=torch.float32, device=dev)
    outs = [mask, active, cut, gcut, nmon]
    packed_ptr = cnt_ptr = None
    if compact:
        packed = torch.empty_like(columns)
        cnt = torch.empty((n_tiles, 1), dtype=torch.int32, device=dev)
        outs += [packed, cnt]
        packed_ptr, cnt_ptr = packed.data_ptr(), cnt.data_ptr()
    err = build().lib.filter_chain_launch(
        columns.data_ptr(), n_cols, n_rows_p, n_tiles, tile,
        specs.column.data_ptr(), specs.op.data_ptr(), specs.t1.data_ptr(),
        specs.t2.data_ptr(), specs.rounds.data_ptr(), perm.data_ptr(),
        specs.group_ids.data_ptr(), n_preds, n_groups, meta.data_ptr(),
        mask.data_ptr(), active.data_ptr(), cut.data_ptr(), gcut.data_ptr(),
        nmon.data_ptr(), packed_ptr, cnt_ptr, fill, pass_ptr, fail_ptr,
        _stream_ptr(dev))
    _check_launch("filter_chain", err)
    filter_chain_kernel.launches += 1
    if skip_decisions is not None:
        filter_chain_kernel.skip_launches += 1
    return tuple(outs)


filter_chain_kernel.launches = 0
filter_chain_kernel.skip_launches = 0


def filter_chain_twin(columns: torch.Tensor, specs, perm: torch.Tensor,
                      meta: torch.Tensor, *, tile: int = DEFAULT_TILE,
                      compact: bool = False, fill: float = 0.0,
                      skip_decisions=None):
    """Plain-PyTorch twin of ``filter_chain_kernel`` (same contract).

    Runs every tile at once over a [C, T, tile] view; reads nothing on the
    host, so it runs on CPU or CUDA tensors alike.
    """
    n_cols, n_rows_p = columns.shape
    if n_rows_p % tile:
        raise ValueError(f"padded rows {n_rows_p} not a multiple of {tile}")
    dev = columns.device
    n_tiles = n_rows_p // tile
    x = columns.reshape(n_cols, n_tiles, tile)
    meta = meta.to(device=dev, dtype=torch.int64)
    n_rows, collect_rate, phase, mode = meta[0], meta[1], meta[2], meta[3]
    lane = torch.arange(tile, dtype=torch.int64, device=dev)
    t_idx = torch.arange(n_tiles, dtype=torch.int64, device=dev)[:, None]
    gidx = t_idx * tile + lane                              # [T, tile]
    valid = gidx < n_rows

    perm = perm.to(device=dev, dtype=torch.int64)
    gpos = specs.group_ids.index_select(0, perm)
    outcomes = pred_lib.eval_all(specs, x)                  # [P, T, tile]
    chain_outcomes = outcomes.index_select(0, perm)

    mask = valid
    if skip_decisions is not None:
        # per-128-row decisions as lanes; decided rows start non-pending
        pass_lane, fail_lane = (
            (d.to(dev).reshape(n_tiles, tile // STAT_TILE) > 0)
            .repeat_interleave(STAT_TILE, dim=1) for d in skip_decisions)
        mask = valid & ~(pass_lane | fail_lane)
    group_or = torch.zeros_like(valid)
    active = []
    for k in range(specs.n):
        is_first = True if k == 0 else gpos[k - 1] != gpos[k]
        closes = True if k == specs.n - 1 else gpos[k + 1] != gpos[k]
        pending = mask if is_first is True \
            else torch.where(is_first, mask, mask & ~group_or)
        alive = pending.sum(dim=1)                          # [T]
        active.append(alive.to(torch.float32))
        # tile short-circuit: a tile with no pending rows evaluates nothing
        res = chain_outcomes[k] & (alive > 0)[:, None]
        group_or = res if is_first is True \
            else torch.where(is_first, res, group_or | res)
        mask = mask & group_or if closes is True \
            else torch.where(closes, mask & group_or, mask)
    if skip_decisions is not None:
        mask = mask | (pass_lane & valid)
    out_mask = mask.reshape(1, n_rows_p).to(torch.int8)
    out_active = torch.stack(active, dim=1)

    # monitor lane: row mode = global stride; block mode = the first 128
    # lanes of every max(collect_rate*128 // tile, 1)-th tile
    row_s = (gidx + phase) % collect_rate == 0
    tile_stride = torch.clamp(collect_rate * 128 // tile, min=1)
    block_s = ((t_idx + phase) % tile_stride == 0) & (lane < 128)
    sampled = torch.where(mode == 1, block_s, row_s) & valid
    nmon = sampled.sum(dim=1, keepdim=True).to(torch.float32)
    fails = ~outcomes
    cut = (fails & sampled).sum(dim=2).T.to(torch.float32)  # [T, P]
    gcut = []
    for members in specs.group_members:
        gfail = fails[members[0]]
        for mi in members[1:]:
            gfail = gfail & fails[mi]
        gcut.append((gfail & sampled).sum(dim=1))
    gcut = torch.stack(gcut, dim=1).to(torch.float32)       # [T, G]
    outs = (out_mask, out_active, cut, gcut, nmon)
    if not compact:
        return outs

    # in-tile pack: exclusive cumsum slot per survivor, fill tail
    pos = torch.cumsum(mask.to(torch.int64), dim=1) - 1
    dest = torch.where(mask, pos, torch.full_like(pos, tile))
    buf = torch.full((n_cols, n_tiles, tile + 1), fill, dtype=columns.dtype,
                     device=dev)
    buf.scatter_(2, dest.expand(n_cols, n_tiles, tile), x)
    packed = buf[:, :, :tile].reshape(n_cols, n_rows_p)
    cnt = mask.sum(dim=1, keepdim=True).to(torch.int32)
    return outs + (packed, cnt)


# =============================================================== gather
def compact_gather_kernel(packed_tiles: torch.Tensor, offsets: torch.Tensor,
                          counts: torch.Tensor, capacity: int, *,
                          fill: float = 0.0):
    """Stitch within-tile-packed survivors into one f32[C, capacity].

    ``offsets`` is the i32[T] exclusive cumsum of the i32[T] ``counts``.
    Tile t contributes min(counts[t], capacity - offsets[t]) survivors at
    offsets[t]; every slot from n_kept = min(total, capacity) on holds
    ``fill`` — the result of ``filter_exec.compact_fixed``.
    """
    dev = packed_tiles.device
    if dev.type == "cpu":
        return compact_gather_twin(packed_tiles, offsets, counts, capacity,
                                   fill=fill)
    if dev.type != "cuda":
        raise KernelRefusal(f"compact_gather_kernel: unsupported device {dev}")
    n_cols, n_rows_p = packed_tiles.shape
    tile = DEFAULT_TILE
    if capacity < 1:
        raise KernelRefusal("capacity must be >= 1")
    if n_rows_p == 0 or n_rows_p % tile:
        raise KernelRefusal(f"padded rows {n_rows_p} not a positive multiple "
                            f"of tile {tile}")
    n_tiles = n_rows_p // tile
    _check_cuda("packed_tiles", packed_tiles, torch.float32, dev)
    _check_cuda("offsets", offsets, torch.int32, dev)
    _check_cuda("counts", counts, torch.int32, dev)
    if offsets.shape != (n_tiles,) or counts.shape != (n_tiles,):
        raise KernelRefusal("offsets and counts must be i32[T]")
    out = torch.empty((n_cols, capacity), dtype=torch.float32, device=dev)
    err = build().lib.compact_gather_launch(
        packed_tiles.data_ptr(), n_cols, n_rows_p, tile, n_tiles,
        offsets.data_ptr(), counts.data_ptr(), capacity, fill,
        out.data_ptr(), _stream_ptr(dev))
    _check_launch("compact_gather", err)
    compact_gather_kernel.launches += 1
    return out


compact_gather_kernel.launches = 0


def compact_gather_twin(packed_tiles: torch.Tensor, offsets: torch.Tensor,
                        counts: torch.Tensor, capacity: int, *,
                        tile: int = DEFAULT_TILE, fill: float = 0.0):
    """Plain-PyTorch twin of ``compact_gather_kernel`` (same contract)."""
    n_cols, n_rows_p = packed_tiles.shape
    dev = packed_tiles.device
    lane = torch.arange(tile, dtype=torch.int64, device=dev)
    dest = offsets.to(device=dev, dtype=torch.int64)[:, None] + lane
    keep = (lane < counts.to(device=dev, dtype=torch.int64)[:, None]) \
        & (dest < capacity)
    dest = torch.where(keep, dest, torch.full_like(dest, capacity))
    out = torch.full((n_cols, capacity + 1), fill, dtype=packed_tiles.dtype,
                     device=dev)
    out[:, dest.reshape(-1)] = packed_tiles
    return out[:, :capacity]


# ================================================================ stats
def tile_stats_kernel(columns: torch.Tensor):
    """Zone maps of padded f32[C, Rp] (Rp % DEFAULT_TILE == 0).

    Returns (mins f32[C, Rp/128], maxs f32[C, Rp/128]): the min and max of
    every column over every 128-row sub-tile, NaN wherever the sub-tile
    holds a NaN — the contract of ``tile_stats_pallas``.
    """
    dev = columns.device
    if dev.type == "cpu":
        return tile_stats_twin(columns)
    if dev.type != "cuda":
        raise KernelRefusal(f"tile_stats_kernel: unsupported device {dev}")
    n_cols, n_rows_p = columns.shape
    if n_rows_p == 0 or n_rows_p % DEFAULT_TILE:
        raise KernelRefusal(f"padded rows {n_rows_p} not a positive multiple "
                            f"of tile {DEFAULT_TILE}")
    _check_cuda("columns", columns, torch.float32, dev)
    if columns.data_ptr() % 16:
        raise KernelRefusal("columns must be 16-byte aligned")
    n_sub = n_rows_p // STAT_TILE
    mins = torch.empty((n_cols, n_sub), dtype=torch.float32, device=dev)
    maxs = torch.empty_like(mins)
    err = build().lib.tile_stats_launch(
        columns.data_ptr(), n_cols * n_sub, mins.data_ptr(), maxs.data_ptr(),
        _stream_ptr(dev))
    _check_launch("tile_stats", err)
    tile_stats_kernel.launches += 1
    return mins, maxs


tile_stats_kernel.launches = 0


def tile_stats_twin(columns: torch.Tensor, *, tile: int = DEFAULT_TILE):
    """Plain-PyTorch twin of ``tile_stats_kernel``: ``amin`` / ``amax``
    (both propagate NaN) over a [C, Rp/128, 128] view. ``tile`` is only
    checked, as ``tile_stats_pallas`` checks it."""
    n_cols, n_rows_p = columns.shape
    if n_rows_p % tile:
        raise ValueError(f"padded rows {n_rows_p} not a multiple of {tile}")
    sub = columns.reshape(n_cols, n_rows_p // STAT_TILE, STAT_TILE)
    return sub.amin(dim=2), sub.amax(dim=2)


def launch_counts() -> dict:
    """Every wrapper's launch counters, by kernel."""
    return dict(chain=filter_chain_kernel.launches,
                skip=filter_chain_kernel.skip_launches,
                gather=compact_gather_kernel.launches,
                stats=tile_stats_kernel.launches)


def reset_launch_counts() -> None:
    """Set every wrapper's launch counters to 0."""
    filter_chain_kernel.launches = 0
    filter_chain_kernel.skip_launches = 0
    compact_gather_kernel.launches = 0
    tile_stats_kernel.launches = 0
