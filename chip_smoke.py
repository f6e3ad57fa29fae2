#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, on a machine with one NVIDIA H100, in
seven phases; any failure exits non-zero:

1. Device: the card's name and power limit, torch and CUDA versions; the
   kernels are built from ``src/repro_torch/kernels/filter_chain/csrc``
   with nvcc and ptxas's register / shared-memory / spill report printed
   (the gather kernel's lines again on their own); ``cuobjdump -sass`` of
   the chain kernel must hold no FFMA (HASHMIX rounds every step on its
   own, and no float division is left), and of the gather kernel no CALL
   (no division routine). These two checks fail the run after phase 4,
   so a kernel that fails them is still measured.
2. Kernel vs twin: the chain and gather kernels against their plain
   PyTorch twins on the card — ragged width (4,194,304 + 777 rows),
   P in {1, 3, 6} with HASHMIX and an OR group, row and block monitor
   mode, compaction on and off, saturating and lossless capacities.
   Every output must be bit-identical. Then the stats kernel (same ragged
   width, NaN, ±inf and ±0 planted inside sub-tiles; NaN positions equal
   and ``==`` elsewhere, since min/max of ±0 may pick either zero), and the
   chain kernel's skip variant on the same P / monitor / compaction grid
   with two sets of decisions: random ones, and the real triage of the
   test columns clustered on column 0 (bit-identical). Then the chain
   kernel's hazards (``hazard_cases``) at a ragged width that is no
   multiple of 8, 32 or 2048: warps without a pending row inside busy
   tiles, P = G = 32, block mode with tile_stride 1 and a nonzero phase,
   HASHMIX first — each mask only, packed, and with skip decisions that
   mix pass, fail and ambiguous sub-tiles in every tile (bit-identical).
   Then the gather kernel's hazards (``repro_torch.kernels.filter_chain.
   gather_cases``, which the tests share): capacity 1, 3, 5 and
   4,194,303, ``n_kept`` 0, equal to the capacity and one below it, a
   tile straddling the capacity, one tile, one and five columns, a fill
   of -0.0 and of NaN; each written into a freed block of a NaN payload,
   so an unwritten slot shows, and compared with the twin through
   ``view(torch.int32)``.
3. The stream: the paper's workload as users run it — ``LogStream`` with
   seed 0 and regime drift (period 750,000 rows, amplitude 1.5), 18
   batches of 2^22 rows x 3 f32 columns (75.5M rows), through
   ``FilterSession.step`` of the paper CNF chain on ``engine="cuda"``
   (compaction off, and on with ``capacity="auto"``) and on
   ``engine="torch"``. The engines must agree exactly on masks, packed
   survivors, ``n_kept``, the perm trajectory and the final ``save_state``
   arrays; epochs must fire; the launch counters must show each kernel ran
   on every step of the path that uses it.
   Then the skip tier on the same stream in the sorted-ingest layout
   (``layout="clustered"``, 8 batches of 2^22 rows): (a) ``zonemap`` on
   both engines, (b) ``zonemap+bloom`` with ``capacity="auto"`` on both,
   (c) ``auto`` on ``cuda`` and (d) ``off`` on both, plus ``zonemap+bloom`` with a
   six-predicate chain holding an EQ predicate (the Bloom proofs fire).
   Masks, packed survivors, ``n_kept``, perm trajectories and final
   ``save_state`` arrays must agree across all of them; (a)'s tile
   counters must be nonzero and equal across engines; the counters must
   show the stats kernel and the skip chain kernel on every skip step.
   Then (phase 3c) the ingestion path as a trainer runs it:
   ``make_pipeline`` over a ``cuda`` session of the paper chain with
   ``compact=True, capacity="auto"`` and ``TokenizeSpec(152_064, 8)``,
   8 batches of 2^22 rows into LM batches of 8 x 4096 tokens. Its batches
   must equal, bit for bit, those of the same pipeline with ``tokenize=None``
   (host tokenize of the survivors); ``tokens_from_padded`` must give the
   same whole tensor and count on the card as on the CPU on the edge block
   (``repro_torch.data.tokenize_cases``); the pipeline state after 3 steps,
   written and read back through the port's checkpoints into a fresh
   pipeline, must give the same next batches; syncs per steady
   ``session.step`` must equal the plan's without tokenize; the counters
   must show the chain and gather kernels on every step. Its numbers: the
   tokenize stage's device time and kernels per step under the profiler
   and its share of the step, and the pipelines' host-clock rows/s and
   tokens/s.
4. Numbers, all taken on this card: each kernel's device time at the
   stream's shapes beside its bound, its twin's time and a one-call
   PyTorch yardstick (the chain rows with two bounds: the rows this batch
   needs, and every column read once); the mask-only chain kernel's time
   split by varying its inputs (no sampled row, HASHMIX cut to one round,
   one predicate beside a one-pass PyTorch compare); the gather's time
   split the same way (copy only, fill only, the ``fill_`` yardstick, a
   saturating and a lossless capacity; ``split`` in its JSON row);
   end-to-end rows/s of
   ``session.step`` for every
   plan, and of the tier on vs off in 6 alternating pairs on ``cuda``;
   device-busy share and kernels per step; device→host syncs per
   steady-state step against the budgets of PERF.md §2.
5. The guarded serving path (``repro_torch.runtime``, ``repro_torch.
   serving``, ``repro_torch.launch.serve``): (a) a chaos soak of
   ``GuardedSession.run_log_stream`` over phase 3's first 12 batches, fed
   from host memory through a ``RequestStream``, paper CNF chain on
   ``cuda`` with ``compact=True, capacity=1_048_576``: two batches
   poisoned, one column storm, one killed step, one state corrupted with
   an infinite cost (``"nan_stat"`` heals at the epoch boundary that every
   2^22-row batch crosses) — clean batches bit-identical to the unguarded ``cuda`` run, the storm
   kept whole, every recovery counted, the only degrade the storm's
   capacity rung; (b) the ladder on the card: from ``cuda`` /
   ``zonemap`` / 1,048,576 on phase 3b's clustered batches, a fault of six
   step attempts walks down to ``torch`` / off / mask compaction (on the
   card, launching nothing) and ``promote_after=2`` climbs back, the
   kernels launched again at the top, masks equal to the unguarded run;
   a fault-free guarded run degrades nothing; then syncs per steady
   guarded step against their budget, the host finite check's time, and
   guarded vs unguarded rows/s in alternating pairs; (c) the serve CLI at
   its defaults (4096 requests, guarded) on the card and on the CPU —
   queued == synchronous, card == CPU on masks and the final state — and
   at 65,536 requests, with req/s and p99 admission latency.
6. Sharding on the card (``repro_torch.core.sharded``): 4 shards of 2^22
   rows a step, all on this card, the batch f32[3, 4 x 2^22] holding phase
   3's batches 4k .. 4k+3 (the stream's round-robin partitions), 4 steps.
   (a) ``per_shard``, ``per_batch`` and ``centralized`` x ``eager`` /
   ``deferred`` / ``deferred-async`` on both engines: ``cuda`` equals
   ``torch`` bit for bit (masks, perm trajectories, ``save_state``
   arrays), ``per_shard`` equals four unsharded sessions on the slices,
   ``centralized`` holds one perm on every shard; rows/s, syncs per steady
   step (budget 0: a sharded step reads nothing, a deferred boundary fires
   from the host mirror), one chain launch per shard a step, and the
   profile of a steady step with the strided slices' copies timed. (b) The
   trainer's sharded input stage: ``make_pipeline`` over 4 shard streams,
   ``centralized``, ``deferred``, ``capacity="auto"``,
   ``TokenizeSpec(152_064, 8)``, the streams' batches served from phase
   3's (the same bytes): LM batches equal the ``torch`` engine's; rows/s
   and tokens/s, and a step's host time split into the shard batches'
   concatenation, the upload and the session step; the state after 3
   steps restores 4→4 bit-identically, and 4→2 and 2→4 with
   ``reshard_state_arrays``' arrays. (c) A guarded 4-shard soak:
   ``per_shard``, capacity 1,048,576 a shard, one poisoned batch
   (quarantined with per-shard zeros), one storm (kept whole), one killed
   step; clean batches equal the fault-free run. Its launch counts go into
   the kernels' JSON as ``launches_sharded``.
7. The paper's host reference path (``AdaptiveFilter(predicates,
   AdaptiveFilterConfig(...)).process_stream``, ``static_filter``):
   (a) Figure 1's sweep as ``benchmarks/fig1_permutations.py`` defines
   it — ``paper_filters_4("fig1")``, ``OrderingConfig(1000, 200_000,
   0.3)``, drift ``none`` and ``regime`` (period 750,000 rows, amplitude
   1.5), 1,500,000 rows in 65,536-row batches (22 batches), the 24 static
   orders and adaptive runs from three initial orders — on ``cuda`` and
   on ``numpy`` with static costs: every batch's mask, perm, epoch and
   ``n_pass`` equal, work units within rel 1e-5, exactly one chain launch
   a batch on ``cuda``; the static spread (worst / best work units) and
   adaptive / best from both engines; then the adaptive runs on ``numpy``
   with ``cost_mode="measured"`` (perms, µs/row; every perm a
   permutation). (b) Phase 3's first 4 batches through ``process_stream``
   on ``cuda`` with ``compact_output=True, compact_capacity="auto"`` and
   on ``numpy``: equal survivors (out of the gather kernel on ``cuda``),
   one chain and one gather launch a batch, rows/s beside phase 3's.
   Its launch counts go into the kernels' JSON as ``launches_host_paths``.

The last two lines before the final one are the kernels' JSON record and
``nvidia-smi --query-gpu=name,power.limit``'s line; the final line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BATCH_ROWS = 1 << 22           # 4,194,304 rows x 3 f32 columns = 48 MiB
N_BATCHES = 18                 # 75.5M rows: the paper's 75M-row dataset
RAGGED_ROWS = BATCH_ROWS + 777
HAZARD_ROWS = 2048 * 700 + 13  # not a multiple of 8, 32 or 2048
N_SKIP_BATCHES = 8             # the clustered skip-tier stream (33.6M rows)
PAIRS = 6                      # alternating off/on pairs of the tier's rate
N_INGEST_BATCHES = 8           # the ingestion pipeline's stream (33.6M rows)
INGEST_VOCAB = 152_064         # qwen2.5-14b's vocab, as the trainer passes it
INGEST_LM = dict(batch_size=8, seq_len=4096)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOP_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
SOURCE = "src/repro_torch/kernels/filter_chain/csrc/filter_chain.cu"
TPU_SOURCE = "src/repro/kernels/filter_chain/filter_chain.py"


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str = "") -> None:
    print(msg, flush=True)


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch is missing: run this script from "
              "a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this smoke "
              "test needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi, sass_failures = phase_device(torch)
    errs = phase_kernels_vs_twins(torch, dev)
    errs.update(phase_skip_kernels_vs_twins(torch, dev))
    phase_hazards(torch, dev, errs)
    phase_gather_hazards(torch, dev, errs)
    runs = phase_stream(torch, dev)
    runs["skip"] = phase_skip_stream(torch, dev,
                                     runs["batches"][:N_SKIP_BATCHES])
    phase_ingest(torch, dev, runs, smi)
    kernels = phase_numbers(torch, dev, runs, errs)
    phase_guarded(torch, dev, runs, smi)
    phase_sharded(torch, dev, runs, kernels, smi)
    phase_host_paths(torch, dev, runs, kernels, smi)
    check(not sass_failures, "phase 1: " + "; ".join(sass_failures))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ===================================================================== 1
def phase_device(torch) -> tuple[str, list]:
    from repro_torch.kernels.filter_chain import filter_chain as fc

    log("== phase 1: device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(f"device: {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()})")
    log(f"nvidia-smi: {smi}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    lib = fc.build()
    log(f"kernel library {lib.path.name} ready in "
        f"{time.perf_counter() - t0:.1f} s; nvcc/ptxas report:")
    for line in lib.log.splitlines():
        if line.strip():
            log(f"  {line}")
    return smi, _check_sass(fc, lib)


def _sass_opcodes(fc, library: Path, kernel: str) -> list:
    """The opcodes of ``kernel``'s body in ``cuobjdump -sass`` of the
    library."""
    cuobjdump = Path(fc._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(library)],
                          capture_output=True, text=True,
                          check=True).stdout
    body = next((part for part in sass.split("Function : ")
                 if kernel in part.split("\n", 1)[0]), None)
    check(body is not None, f"cuobjdump shows no {kernel}")
    opcodes = []     # "/*0220*/  @!P0 FADD R1, R2, R3 ;  /* 0x... */"
    for line in body.splitlines():
        words = line.split("*/", 1)[1].split() if "*/" in line else []
        if words and words[0].startswith("@"):
            words = words[1:]
        if words and not words[0].startswith("/*"):
            opcodes.append(words[0])
    return opcodes


def _ptxas_lines(log_text: str, kernel: str) -> list:
    """ptxas's report for ``kernel``: the lines from its "Compiling entry
    function" line up to the next kernel's."""
    lines, inside = [], False
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            inside = kernel in line
        if inside and line.strip():
            lines.append(line.strip())
    return lines


def _check_sass(fc, lib) -> list:
    """Machine-code checks; returns the failures found, which ``main``
    raises after phase 4 so that a failing kernel is still measured.

    * ``chain_kernel`` holds no FFMA: a fused multiply-add would be a
      HASHMIX step contracted (its rounding differs from the twin's) or
      the refinement of a float division, which the kernel replaces by an
      exact multiply. MUFU.RCP stays for integer modulos.
    * ``compact_gather_kernel`` holds no CALL: a call there is a division
      routine (the 64-bit one an index split by ``/`` and ``%`` brings)
      back on every element of the fill."""
    failures = []
    names = ("FFMA", "FMUL", "FADD", "FRND", "MUFU.RCP", "CALL")
    for kernel, banned in (("chain_kernel", "FFMA"),
                           ("compact_gather_kernel", "CALL")):
        opcodes = _sass_opcodes(fc, lib.path, kernel)
        count = {name: sum(o.startswith(name) for o in opcodes)
                 for name in names}
        count["STG .128"] = sum(o.startswith("STG") and o.endswith(".128")
                                for o in opcodes)
        log(f"  {kernel} SASS: {len(opcodes)} instructions; {count}")
        if count[banned]:
            failures.append(f"{kernel}'s SASS holds {count[banned]} "
                            f"{banned}")
    for line in _ptxas_lines(lib.log, "compact_gather_kernel"):
        log(f"  compact_gather_kernel ptxas: {line}")
    return failures


# ===================================================================== 2
def _test_columns(torch, dev, n_rows, seed):
    import numpy as np

    r = np.random.default_rng(seed)
    cols = np.stack([
        r.uniform(0, 1, n_rows), r.uniform(0, 1, n_rows),
        r.integers(0, 8, n_rows).astype(np.float64),
        r.uniform(0, 1048576.0, n_rows)]).astype(np.float32)
    return torch.from_numpy(cols).to(dev)


def _test_chains():
    from repro_torch.core import predicates as P

    mix = P.Predicate("mix", 3, P.OP_HASHMIX, 0.45 * P.MIX_MOD, rounds=24,
                      static_cost=6.0)
    return {
        1: ([mix], [0]),
        3: ([P.Predicate("gt", 0, P.OP_GT, 0.2),
             P.Predicate("lt", 1, P.OP_LT, 0.3, group="or"),
             P.Predicate("mix", 3, P.OP_HASHMIX, 0.45 * P.MIX_MOD, rounds=24,
                         group="or", static_cost=6.0)], [2, 1, 0]),
        6: ([P.Predicate("gt", 0, P.OP_GT, 0.6, group="a"),
             P.Predicate("lt", 1, P.OP_LT, 0.3, group="a"),
             P.Predicate("bet", 0, P.OP_BETWEEN, 0.1, t2=0.9),
             P.Predicate("eq", 2, P.OP_EQ, 3.0, group="b"),
             P.Predicate("mix", 3, P.OP_HASHMIX, 0.45 * P.MIX_MOD, rounds=24,
                         group="b", static_cost=6.0),
             P.Predicate("gt2", 1, P.OP_GT, 0.05)], [4, 3, 2, 5, 1, 0]),
    }


def _max_abs_err(torch, got, want) -> float:
    """max |got - want| over the entries where it is a number (packed
    buffers carry the batch's NaN and inf values through)."""
    d = (got.to(torch.float64) - want.to(torch.float64)).abs()
    d = d[~torch.isnan(d)]
    return float(d.max()) if d.numel() else 0.0


def _bits_equal(torch, got, want) -> bool:
    """Bit-identical: f32 outputs compare as their i32 bit patterns, so a
    NaN carried into a packed buffer compares equal to itself."""
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    return torch.equal(got, want)


def phase_kernels_vs_twins(torch, dev) -> dict:
    """Kernel vs twin; returns the max |kernel - twin| of each kernel."""
    from repro_torch.core import predicates as P
    from repro_torch.kernels.filter_chain import filter_chain as fc

    log("== phase 2: kernels vs twins on the card "
        f"({RAGGED_ROWS} rows, ragged)")
    names = ("mask", "active", "cut", "gcut", "nmon", "packed", "cnt")
    errs = {"chain": 0.0, "gather": 0.0}
    cols = _test_columns(torch, dev, RAGGED_ROWS, seed=1)
    padded = torch.nn.functional.pad(cols,
                                     (0, (-RAGGED_ROWS) % fc.DEFAULT_TILE))
    for n_preds, (preds, perm) in _test_chains().items():
        specs = P.pack(preds, dev)
        perm_t = torch.tensor(perm, dtype=torch.int32).to(dev)
        for mode in (0, 1):
            meta = torch.tensor([RAGGED_ROWS, 1000, 7, mode],
                                dtype=torch.int32).to(dev)
            for compact in (False, True):
                got = fc.filter_chain_kernel(padded, specs, perm_t, meta,
                                             compact=compact, fill=-1.0)
                want = fc.filter_chain_twin(padded, specs, perm_t, meta,
                                            compact=compact, fill=-1.0)
                torch.cuda.synchronize()
                for name, g, w in zip(names, got, want):
                    check(g.dtype == w.dtype and g.shape == w.shape,
                          f"chain kernel output {name} has the wrong type")
                    errs["chain"] = max(errs["chain"],
                                        _max_abs_err(torch, g, w))
                    check(torch.equal(g, w),
                          f"chain kernel != twin: P={n_preds} mode={mode} "
                          f"compact={compact} output={name}")
            cnt = got[6][:, 0]
            total = int(cnt.sum())
            offsets = torch.cumsum(cnt, 0, dtype=torch.int32) - cnt
            for cap in (max(total // 3, 1), total + 4096):
                g = fc.compact_gather_kernel(got[5], offsets, cnt, cap,
                                             fill=-1.0)
                w = fc.compact_gather_twin(got[5], offsets, cnt, cap,
                                           fill=-1.0)
                torch.cuda.synchronize()
                errs["gather"] = max(errs["gather"],
                                     _max_abs_err(torch, g, w))
                check(torch.equal(g, w), f"gather kernel != twin: "
                      f"P={n_preds} mode={mode} capacity={cap}")
                n_kept = min(total, cap)
                mask = got[0][0, :RAGGED_ROWS].bool()
                check(torch.equal(g[:, :n_kept], cols[:, mask][:, :n_kept]),
                      "gathered survivors != boolean-mask survivors")
                check(bool((g[:, n_kept:] == -1.0).all()),
                      "gather tail is not the fill value")
            log(f"  P={n_preds} mode={'block' if mode else 'row'}: chain "
                f"(mask, pack) and gather (capacity {max(total // 3, 1)} "
                f"saturating, {total + 4096} lossless) bit-identical; "
                f"{total} survivors")
    return errs


def _summary_err(torch, got, want, what: str) -> float:
    """Zone maps: NaN positions must be equal; elsewhere ``==`` (the min of
    0.0 and -0.0 may be either zero, and no proof can tell them apart).
    Returns the max |kernel - twin| over the non-NaN entries."""
    check(torch.equal(torch.isnan(got), torch.isnan(want)),
          f"stats kernel != twin: NaN positions of {what}")
    keep = ~torch.isnan(want)
    check(bool((got[keep] == want[keep]).all()),
          f"stats kernel != twin: values of {what}")
    finite = keep & torch.isfinite(want)
    return _max_abs_err(torch, got[finite], want[finite])


def phase_skip_kernels_vs_twins(torch, dev) -> dict:
    """The stats kernel and the chain kernel's skip variant vs their twins;
    returns the max |kernel - twin| of each."""
    import numpy as np

    from repro_torch.core import predicates as P
    from repro_torch.core import skip_tier
    from repro_torch.kernels.filter_chain import filter_chain as fc
    from repro_torch.kernels.filter_chain import ops

    log("== phase 2b: stats kernel and skip chain kernel vs twins "
        f"({RAGGED_ROWS} rows, ragged)")
    errs = {"stats": 0.0, "skip": 0.0}
    cols = _test_columns(torch, dev, RAGGED_ROWS, seed=2)
    # NaN, ±inf and ±0 planted inside sub-tiles (and in the ragged tail)
    cols[0, 5] = float("nan")
    cols[1, 300] = float("inf")
    cols[1, 301] = float("-inf")
    cols[2, 512:640] = 0.0
    cols[2, 520] = -0.0
    cols[3, 700:828] = -0.0
    cols[3, 710] = 0.0
    cols[0, RAGGED_ROWS - 3] = float("nan")
    cols[1, 2_000_000:2_000_128] = float("inf")
    padded = torch.nn.functional.pad(cols,
                                     (0, (-RAGGED_ROWS) % fc.DEFAULT_TILE))
    got = fc.tile_stats_kernel(padded)
    want = fc.tile_stats_twin(padded)
    torch.cuda.synchronize()
    for g, w, what in zip(got, want, ("mins", "maxs")):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"stats kernel output {what} has the wrong type")
        errs["stats"] = max(errs["stats"], _summary_err(torch, g, w, what))
    n_nan = int(torch.isnan(got[0]).sum())
    check(n_nan == 2, f"expected 2 NaN sub-tiles in mins, got {n_nan}")
    log(f"  tile_stats: mins/maxs [{got[0].shape[0]}, {got[0].shape[1]}] "
        f"equal to the twin (NaN positions, then ==); {n_nan} NaN "
        "sub-tiles")

    # decisions: random, and the real triage of the columns clustered on
    # column 0 (a stable device sort), bloom on
    order = torch.sort(cols[0].nan_to_num(0.0), stable=True).indices
    clustered = cols[:, order].contiguous()
    cl_padded = torch.nn.functional.pad(
        clustered, (0, (-RAGGED_ROWS) % fc.DEFAULT_TILE))
    n_sub = padded.shape[1] // fc.STAT_TILE
    r = np.random.default_rng(3)
    rnd_pass = r.uniform(size=n_sub) < 0.3
    rnd_fail = ~rnd_pass & (r.uniform(size=n_sub) < 0.4)
    rand = tuple(torch.from_numpy(d.astype(np.int32)).to(dev)
                 for d in (rnd_pass, rnd_fail))
    names = ("mask", "active", "cut", "gcut", "nmon", "packed", "cnt")
    for n_preds, (preds, perm) in _test_chains().items():
        specs = P.pack(preds, dev)
        perm_t = torch.tensor(perm, dtype=torch.int32).to(dev)
        info = ops.skip_triage(clustered, specs, bloom=True)
        real = (info.pass_tiles.to(torch.int32),
                info.fail_tiles.to(torch.int32))
        n_pass, n_fail, n_amb = (int(x) for x in
                                 skip_tier.tile_counters(info))
        for label, data, dec in (("random", padded, rand),
                                 ("triage", cl_padded, real)):
            for mode in (0, 1):
                meta = torch.tensor([RAGGED_ROWS, 1000, 7, mode],
                                    dtype=torch.int32).to(dev)
                for compact in (False, True):
                    got = fc.filter_chain_kernel(data, specs, perm_t, meta,
                                                 compact=compact, fill=-1.0,
                                                 skip_decisions=dec)
                    want = fc.filter_chain_twin(data, specs, perm_t, meta,
                                                compact=compact, fill=-1.0,
                                                skip_decisions=dec)
                    torch.cuda.synchronize()
                    for name, g, w in zip(names, got, want):
                        check(g.dtype == w.dtype and g.shape == w.shape,
                              f"skip chain output {name} has the wrong type")
                        errs["skip"] = max(errs["skip"],
                                           _max_abs_err(torch, g, w))
                        check(_bits_equal(torch, g, w),
                              f"skip chain kernel != twin: P={n_preds} "
                              f"{label} mode={mode} compact={compact} "
                              f"output={name}")
        log(f"  P={n_preds}: skip chain (row/block, mask/pack) bit-identical "
            f"to the twin with random decisions and with the clustered "
            f"triage ({n_pass} pass / {n_fail} fail / {n_amb} ambiguous "
            "sub-tiles)")
    return errs


def hazard_cases(torch, dev, n_rows: int):
    """The chain kernel's hazards at ``n_rows`` rows: a list of (label,
    padded f32[4, Rp], specs, perm, meta), and skip decisions that mix
    pass, fail and ambiguous sub-tiles inside every tile."""
    import numpy as np

    from repro_torch.core import predicates as P
    from repro_torch.kernels.filter_chain import filter_chain as fc

    tile = fc.DEFAULT_TILE
    cols = _test_columns(torch, dev, n_rows, seed=4)
    # column 0 sorted inside every full tile: a GT on it cuts whole warps
    # while the rest of the tile stays pending
    n_full = n_rows // tile * tile
    order = torch.arange(n_rows, device=dev)
    within = torch.sort(cols[0, :n_full].reshape(-1, tile), dim=1,
                        stable=True).indices
    order[:n_full] = (within + torch.arange(0, n_full, tile, device=dev)
                      [:, None]).reshape(-1)
    tiled = cols[:, order].contiguous()
    mix = P.MIX_MOD
    chain3, perm3 = _test_chains()[3]            # HASHMIX at position 0
    chain6, perm6 = _test_chains()[6]
    warps = [P.Predicate("gt", 0, P.OP_GT, 0.6),
             P.Predicate("lt", 1, P.OP_LT, 0.3, group="or"),
             P.Predicate("mix", 3, P.OP_HASHMIX, 0.45 * mix, rounds=24,
                         group="or")]
    p32 = []                                     # 32 singleton groups
    for i in range(fc.MAX_PREDS):
        c = i % 4
        if i == 30:
            p32.append(P.Predicate(f"eq{i}", 2, P.OP_EQ, 3.0))
        elif c == 0:
            p32.append(P.Predicate(f"gt{i}", 0, P.OP_GT, 0.01 * (i % 7)))
        elif c == 1:
            p32.append(P.Predicate(f"lt{i}", 1, P.OP_LT, 1 - 0.01 * (i % 7)))
        elif c == 2:
            p32.append(P.Predicate(f"bet{i}", 2, P.OP_BETWEEN,
                                   -0.5 + (i % 3 == 0), t2=7.5))
        else:
            p32.append(P.Predicate(f"mix{i}", 3, P.OP_HASHMIX, 0.03 * mix,
                                   rounds=1 + i % 24))
    perm32 = np.random.default_rng(32).permutation(fc.MAX_PREDS).tolist()

    def pad(c):
        return torch.nn.functional.pad(c, (0, (-n_rows) % tile))

    def meta(collect_rate, phase, mode):
        return torch.tensor([n_rows, collect_rate, phase, mode],
                            dtype=torch.int32).to(dev)

    cases = [
        ("ragged rows, P=6", pad(cols), chain6, perm6, meta(1000, 7, 0)),
        ("warps without pending rows in busy tiles", pad(tiled), warps,
         [0, 2, 1], meta(1000, 7, 0)),
        ("P=G=32", pad(cols), p32, perm32, meta(37, 3, 0)),
        ("block mode, tile_stride 1, phase 5", pad(cols), chain6, perm6,
         meta(16, 5, 1)),
        ("HASHMIX first", pad(cols), chain3, perm3, meta(1000, 7, 0)),
    ]
    n_sub = pad(cols).shape[1] // fc.STAT_TILE
    sub = torch.arange(n_sub, device=dev) % 3
    mixed = ((sub == 0).to(torch.int32), (sub == 1).to(torch.int32))
    return [(label, x, P.pack(preds, dev),
             torch.tensor(perm, dtype=torch.int32).to(dev), m)
            for label, x, preds, perm, m in cases], mixed


def phase_hazards(torch, dev, errs: dict, n_rows: int = HAZARD_ROWS) -> None:
    """Every variant of the chain kernel on its hazard cases, bit for bit
    against the twin; raises ``errs`` "chain" and "skip" to the largest
    |kernel - twin| seen."""
    from repro_torch.kernels.filter_chain import filter_chain as fc

    log(f"== phase 2c: chain kernel hazards ({n_rows} rows)")
    names = ("mask", "active", "cut", "gcut", "nmon", "packed", "cnt")
    cases, mixed = hazard_cases(torch, dev, n_rows)
    for label, padded, specs, perm, meta in cases:
        for dec in (None, mixed):
            for compact in (False, True):
                kw = dict(compact=compact, fill=-1.0, skip_decisions=dec)
                got = fc.filter_chain_kernel(padded, specs, perm, meta, **kw)
                want = fc.filter_chain_twin(padded, specs, perm, meta, **kw)
                torch.cuda.synchronize()
                key = "chain" if dec is None else "skip"
                for name, g, w in zip(names, got, want):
                    check(g.dtype == w.dtype and g.shape == w.shape,
                          f"chain output {name} has the wrong type")
                    errs[key] = max(errs[key], _max_abs_err(torch, g, w))
                    check(_bits_equal(torch, g, w),
                          f"chain kernel != twin: {label}, skip="
                          f"{dec is not None} compact={compact} "
                          f"output={name}")
        log(f"  {label}: mask, pack and skip (pass/fail/ambiguous "
            f"sub-tiles in every tile) bit-identical; "
            f"{int(got[6].sum())} survivors with the skip decisions")


def phase_gather_hazards(torch, dev, errs: dict,
                         n_rows: int = HAZARD_ROWS) -> None:
    """The gather kernel on its hazard cases (``gather_cases``), bit for
    bit (through ``view(torch.int32)``) against the twin, each written
    into the freed block of a NaN-payload sentinel so that an unwritten
    slot shows; raises ``errs["gather"]`` to the largest |kernel - twin|
    seen."""
    from repro_torch.kernels.filter_chain import filter_chain as fc
    from repro_torch.kernels.filter_chain import gather_cases

    log(f"== phase 2c: gather kernel hazards (packs of {n_rows} rows)")
    for label in gather_cases.HAZARDS + gather_cases.HAZARDS_WIDE:
        packed, off, cnt, cap, fill = gather_cases.hazard(label, n_rows,
                                                          device=dev)
        got, in_sentinel = gather_cases.gather_in_sentinel(packed, off, cnt,
                                                           cap, fill)
        check(in_sentinel, f"the allocator did not hand the gather the "
              f"sentinel's block: {label}")
        want = fc.compact_gather_twin(packed, off, cnt, cap, fill=fill)
        torch.cuda.synchronize()
        check(got.dtype == want.dtype and got.shape == want.shape,
              f"gather output has the wrong type: {label}")
        errs["gather"] = max(errs["gather"], _max_abs_err(torch, got, want))
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"gather kernel != twin: {label}")
        total = int(cnt.sum())
        log(f"  {label}: {packed.shape[0]} columns, {cnt.numel()} tiles, "
            f"capacity {cap}, {min(total, cap)} of {total} kept, fill "
            f"{fill}: bit-identical")


# ===================================================================== 3
def _stream_batches(torch, dev):
    from repro_torch.configs.paper_filters import PaperWorkload
    from repro_torch.data.stream import LogStream

    wl = PaperWorkload()
    stream = LogStream(N_BATCHES * BATCH_ROWS, BATCH_ROWS, seed=0,
                       drift=wl.drift)
    return [torch.from_numpy(b.columns).to(dev) for b in stream], wl


def _drive(torch, session, batches, *, record: bool, count_syncs: bool,
           sync_sites: set | None = None):
    """Steps the session over the batches; returns (state, steps, syncs,
    seconds). Device→host syncs are counted per step from step 1 on (the
    steady state) under the "warn" sync debug mode, which is switched on
    once before the first step and off after the last, so the switch itself
    falls in no counted step; each sync's source line goes to
    ``sync_sites``."""
    state = session.init_state()
    steps, syncs = [], []
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if count_syncs:
            torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        for i, cols in enumerate(batches):
            seen = len(caught)
            state, res = session.step(state, cols)
            if count_syncs and i > 0:
                hits = [w for w in caught[seen:]
                        if "synchroniz" in str(w.message).lower()]
                syncs.append(len(hits))
                if sync_sites is not None:
                    sync_sites.update(
                        f"step {i}: {Path(w.filename).name}:{w.lineno}"
                        for w in hits)
            if record:
                m = res.metrics
                steps.append(dict(mask=res.mask, packed=res.packed,
                                  n_kept=res.n_kept, perm=state.perm,
                                  group_perm=state.group_perm,
                                  capacity=res.capacity,
                                  tiles=(m.n_tiles_pass, m.n_tiles_fail,
                                         m.n_tiles_ambiguous)))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if count_syncs:
            torch.cuda.set_sync_debug_mode("default")
    return state, steps, syncs, seconds


def phase_stream(torch, dev) -> dict:
    from repro_torch.configs.paper_filters import filter_chain
    from repro_torch.core import FilterPlan, build_session
    from repro_torch.kernels.filter_chain import filter_chain as fc
    from repro_torch.kernels.filter_chain.ref import filter_chain_ref

    log(f"== phase 3: the stream ({N_BATCHES} x {BATCH_ROWS} rows, "
        "paper CNF chain, regime drift)")
    t0 = time.perf_counter()
    batches, wl = _stream_batches(torch, dev)
    log(f"  generated and uploaded {N_BATCHES} batches in "
        f"{time.perf_counter() - t0:.1f} s")
    chain = filter_chain("cnf")
    plans = {
        "off": dict(),
        "auto": dict(compact=True, capacity="auto"),
    }
    runs: dict = {"batches": batches}
    for label, kw in plans.items():
        rec = {}
        for engine in ("cuda", "torch"):
            plan = FilterPlan(chain, wl.ordering, engine=engine, **kw)
            fc.reset_launch_counts()
            session = build_session(plan)
            sites: set = set()
            state, steps, syncs, _ = _drive(torch, session, batches,
                                            record=True, count_syncs=True,
                                            sync_sites=sites)
            launches = (fc.filter_chain_kernel.launches,
                        fc.compact_gather_kernel.launches)
            _, _, _, seconds = _drive(torch, build_session(plan), batches,
                                      record=False, count_syncs=False)
            rec[engine] = dict(state=state, steps=steps, syncs=syncs,
                               launches=launches, seconds=seconds,
                               session=session,
                               arrays=session.save_state(state)["arrays"])
            rows_s = N_BATCHES * BATCH_ROWS / seconds
            log(f"  engine={engine} compact={label}: {rows_s:,.0f} rows/s "
                f"end to end ({seconds * 1e3:.1f} ms for {N_BATCHES} steps, "
                f"host clock + synchronize); syncs per steady step "
                f"{syncs}; launches (chain, gather) = {launches}; final "
                f"epoch {int(state.epoch)}, perm {state.perm.tolist()}")
            for site in sorted(sites)[:8]:
                log(f"    sync at {site}")
            # PERF.md §2: no sync in a steady step, except the one read of
            # the auto-capacity retune
            limit = 1 if kw.get("capacity") == "auto" else 0
            check(max(syncs) <= limit,
                  f"engine={engine} compact={label}: {max(syncs)} "
                  f"device->host syncs in a steady step, limit {limit}")
        cu, to = rec["cuda"], rec["torch"]
        want_chain = N_BATCHES
        want_gather = N_BATCHES if kw.get("compact") else 0
        check(cu["launches"] == (want_chain, want_gather),
              f"cuda engine launches {cu['launches']} != "
              f"{(want_chain, want_gather)} on compact={label}")
        check(to["launches"] == (0, 0),
              f"torch engine launched kernels {to['launches']}")
        check(int(cu["state"].epoch) >= N_BATCHES // 2,
              f"epochs did not fire: epoch {int(cu['state'].epoch)}")
        for i, (a, b) in enumerate(zip(cu["steps"], to["steps"])):
            check(torch.equal(a["mask"], b["mask"]), f"mask differs, step {i}")
            check(torch.equal(a["perm"], b["perm"])
                  and torch.equal(a["group_perm"], b["group_perm"]),
                  f"perm trajectory differs, step {i}")
            if a["packed"] is not None:
                check(a["capacity"] == b["capacity"],
                      f"capacity differs, step {i}")
                check(int(a["n_kept"]) == int(b["n_kept"]),
                      f"n_kept differs, step {i}")
                check(torch.equal(a["packed"], b["packed"]),
                      f"packed buffer differs, step {i}")
                check(int(a["n_kept"]) > 0
                      and bool(torch.isfinite(a["packed"]).all()),
                      f"packed survivors empty or not finite, step {i}")
        for k, v in cu["arrays"].items():
            w = to["arrays"][k]
            check(v.dtype == w.dtype and v.shape == w.shape
                  and (v == w).all(), f"save_state array {k} differs")
        caps = [s["capacity"] for s in cu["steps"]]
        log(f"  compact={label}: cuda == torch on masks, packed, n_kept, "
            f"perm trajectory and save_state arrays; capacities {caps}")
        runs[label] = rec

    # the port's dense oracle on a small slice of batch 0
    small = batches[0][:, :100_000].contiguous()
    from repro_torch.core import MonitorSpec, get_engine, pack
    specs = pack(chain, dev)
    perm = runs["off"]["cuda"]["state"].perm
    got = get_engine("cuda").run_chain(small, specs, perm,
                                       MonitorSpec(1000, 0))
    want = filter_chain_ref(small, specs, perm, collect_rate=1000,
                            sample_phase=0)
    for f in ("mask", "active_before", "cut_counts", "n_monitored",
              "group_cut_counts"):
        check(torch.equal(getattr(got, f), getattr(want, f)),
              f"cuda engine vs dense oracle: {f}")
    log("  cuda engine == dense oracle on 100,000 rows of batch 0")
    return runs


def _stream_chain6():
    """Six predicates over the stream's columns with the structure of phase
    2's six-chain (two OR groups, a BETWEEN, an EQ, HASHMIX); the EQ shares
    its group with a range predicate, so Bloom proofs decide tiles."""
    from repro_torch.core import predicates as P
    from repro_torch.data.stream import threshold_for_quantile as q

    return [
        P.Predicate("date_gt", 0, P.OP_GT, q("date", 0.3), group="a"),
        P.Predicate("int_lt", 1, P.OP_LT, q("int", 0.2), group="a"),
        P.Predicate("date_bt", 0, P.OP_BETWEEN, q("date", 0.05),
                    t2=q("date", 0.95), static_cost=1.5),
        P.Predicate("str_eq", 2, P.OP_EQ, 777.0, group="b"),
        P.Predicate("int_gt", 1, P.OP_GT, q("int", 0.97), group="b"),
        P.Predicate("str_mix", 2, P.OP_HASHMIX, 0.3 * P.MIX_MOD, rounds=24,
                    static_cost=6.0),
    ]


#: PERF.md §2: device→host syncs allowed in a steady step, by plan and
#: engine — the torch engine reads its ambiguous count (1), auto reads the
#: tier arm's tile counters (1), capacity="auto" retunes (1)
SKIP_SYNC_BUDGET = {
    ("a", "cuda"): 0, ("a", "torch"): 1,
    ("b", "cuda"): 1, ("b", "torch"): 2,
    ("c", "cuda"): 1, ("d", "cuda"): 0, ("d", "torch"): 0,
    ("bloom6", "cuda"): 0, ("bloom6", "torch"): 1, ("off6", "cuda"): 0,
}


def _host_tiles(step) -> tuple:
    return tuple(int(t) for t in step["tiles"])


def _cluster(torch, cols):
    """``layout="clustered"`` of one generated batch, on the device: the
    generator's ``np.lexsort((date, int))`` as two stable sorts (date,
    then int), so the rows land in the same order."""
    by_date = cols[:, torch.sort(cols[0], stable=True).indices]
    return by_date[:, torch.sort(by_date[1], stable=True).indices] \
        .contiguous()


def phase_skip_stream(torch, dev, iid_batches) -> dict:
    """The skip tier on the clustered paper stream; returns the runs.

    ``iid_batches`` are phase 3's first batches; clustering them on the
    device gives the stream's ``layout="clustered"`` batches (checked
    against the host generator on batch 0) without the host's sorts.
    """
    from repro_torch.configs.paper_filters import PaperWorkload, filter_chain
    from repro_torch.core import FilterPlan, build_session
    from repro_torch.data.stream import gen_batch
    from repro_torch.kernels.filter_chain import filter_chain as fc

    log(f"== phase 3b: the skip tier ({N_SKIP_BATCHES} x {BATCH_ROWS} rows, "
        "layout=clustered, regime drift)")
    wl = PaperWorkload()
    t0 = time.perf_counter()
    batches = [_cluster(torch, b) for b in iid_batches]
    host0 = gen_batch(0, 0, 0, BATCH_ROWS, wl.drift, layout="clustered")
    check(torch.equal(batches[0].cpu(), torch.from_numpy(host0)),
          "device clustering != the generator's clustered layout")
    log(f"  clustered {N_SKIP_BATCHES} batches on the device, batch 0 equal "
        "to the generator's layout=clustered batch, in "
        f"{time.perf_counter() - t0:.1f} s")
    cnf = filter_chain("cnf")
    plans = {   # label → (chain, engines, plan fields)
        "a": (cnf, ("cuda", "torch"), dict(skip_tier="zonemap")),
        "b": (cnf, ("cuda", "torch"), dict(skip_tier="zonemap+bloom",
                                           compact=True, capacity="auto")),
        "c": (cnf, ("cuda",), dict(skip_tier="auto")),
        "d": (cnf, ("cuda", "torch"), dict(skip_tier="off")),
        "bloom6": (_stream_chain6(), ("cuda", "torch"),
                   dict(skip_tier="zonemap+bloom")),
        "off6": (_stream_chain6(), ("cuda",), dict(skip_tier="off")),
    }
    runs: dict = {"batches": batches}
    for label, (chain, engines, kw) in plans.items():
        for engine in engines:
            plan = FilterPlan(chain, wl.ordering, engine=engine, **kw)
            fc.reset_launch_counts()
            session = build_session(plan)
            sites: set = set()
            state, steps, syncs, _ = _drive(torch, session, batches,
                                            record=True, count_syncs=True,
                                            sync_sites=sites)
            launches = dict(chain=fc.filter_chain_kernel.launches,
                            skip=fc.filter_chain_kernel.skip_launches,
                            gather=fc.compact_gather_kernel.launches,
                            stats=fc.tile_stats_kernel.launches)
            timed = build_session(plan)
            _, _, _, seconds = _drive(torch, timed, batches, record=False,
                                      count_syncs=False)
            tiles = [_host_tiles(st) for st in steps]
            rec = dict(state=state, steps=steps, syncs=syncs, tiles=tiles,
                       launches=launches, seconds=seconds, plan=plan,
                       arrays=session.save_state(state)["arrays"])
            runs[(label, engine)] = rec
            rows_s = N_SKIP_BATCHES * BATCH_ROWS / seconds
            log(f"  plan ({label}) {kw} engine={engine}: {rows_s:,.0f} rows/s "
                f"({seconds * 1e3:.1f} ms for {N_SKIP_BATCHES} steps); syncs "
                f"per steady step {syncs}; launches {launches}; tiles "
                f"(pass, fail, ambiguous) per step {tiles[:3]}...; final "
                f"perm {state.perm.tolist()}")
            for site in sorted(sites)[:8]:
                log(f"    sync at {site}")
            limit = SKIP_SYNC_BUDGET[(label, engine)]
            check(max(syncs) <= limit,
                  f"plan ({label}) engine={engine}: {max(syncs)} "
                  f"device->host syncs in a steady step, limit {limit}")
            # the launch counters: stats + skip chain on every skip step
            n = N_SKIP_BATCHES
            skip_steps = sum(1 for t in tiles if sum(t) > 0)
            if engine == "torch":
                check(all(v == 0 for v in launches.values()),
                      f"torch engine launched kernels {launches}")
                continue
            want_skip = {"a": n, "b": n, "c": skip_steps, "d": 0,
                         "bloom6": n, "off6": 0}[label]
            check(skip_steps == want_skip,
                  f"plan ({label}): {skip_steps} skip steps, want "
                  f"{want_skip}")
            check(launches["chain"] == n and launches["skip"] == want_skip
                  and launches["stats"] == want_skip
                  and launches["gather"] == (n if kw.get("compact") else 0),
                  f"plan ({label}) cuda launches {launches}: want chain {n}, "
                  f"skip and stats {want_skip}")
            if label == "c":
                check(0 < skip_steps < n, "auto never alternated its arms")

    # exactness: the tier never changes which rows survive
    base = runs[("d", "cuda")]
    for key, rec in runs.items():
        if key == "batches" or key[0] in ("bloom6", "off6"):
            continue
        _same_run(torch, rec, base, f"plan {key} vs (d)")
    _same_run(torch, runs[("bloom6", "cuda")], runs[("off6", "cuda")],
              "bloom6 cuda vs off6")
    _same_run(torch, runs[("bloom6", "torch")], runs[("off6", "cuda")],
              "bloom6 torch vs off6")
    for label in ("a", "b", "bloom6"):
        cu, to = runs[(label, "cuda")], runs[(label, "torch")]
        check(cu["tiles"] == to["tiles"],
              f"plan ({label}) tile counters differ across engines")
        check(all(t[1] > 0 for t in cu["tiles"]),
              f"plan ({label}): a step decided no failing tile")
    b_cu, b_to = runs[("b", "cuda")], runs[("b", "torch")]
    for i, (a, b, cols) in enumerate(zip(b_cu["steps"], b_to["steps"],
                                         batches)):
        check(a["capacity"] == b["capacity"], f"capacity differs, step {i}")
        n_kept = int(a["n_kept"])
        check(n_kept == int(b["n_kept"]) and n_kept > 0,
              f"n_kept differs or is 0, step {i}")
        check(torch.equal(a["packed"], b["packed"]),
              f"packed buffer differs across engines, step {i}")
        check(torch.equal(a["packed"][:, :n_kept],
                          cols[:, a["mask"]][:, :n_kept]),
              f"packed survivors != boolean-mask survivors, step {i}")
    bloom = runs[("bloom6", "cuda")]["tiles"]
    zmap_only = _zonemap_fail_tiles(torch, batches)
    check(sum(t[1] for t in bloom) > zmap_only,
          f"Bloom proofs decided no tile: {sum(t[1] for t in bloom)} fail "
          f"tiles with Bloom, {zmap_only} from zone maps alone")
    log(f"  (a)-(d) agree on masks, n_kept, packed, perm trajectories and "
        f"save_state arrays; (a) tile counters equal across engines "
        f"{runs[('a', 'cuda')]['tiles'][:2]}...; six-chain fail tiles "
        f"{sum(t[1] for t in bloom)} with Bloom vs {zmap_only} from zone "
        "maps alone")
    return runs


def _zonemap_fail_tiles(torch, batches) -> int:
    """Fail tiles of the six-chain from zone maps alone over the batches."""
    from repro_torch.core import pack
    from repro_torch.kernels.filter_chain import ops

    specs = pack(_stream_chain6(), batches[0].device)
    return sum(int(ops.skip_triage(b, specs, bloom=False).fail_tiles.sum())
               for b in batches)


def _same_run(torch, got, want, what: str) -> None:
    for i, (a, b) in enumerate(zip(got["steps"], want["steps"])):
        check(torch.equal(a["mask"], b["mask"]), f"{what}: mask, step {i}")
        check(torch.equal(a["perm"], b["perm"])
              and torch.equal(a["group_perm"], b["group_perm"]),
              f"{what}: perm trajectory, step {i}")
    for k, v in want["arrays"].items():
        w = got["arrays"][k]
        check(v.dtype == w.dtype and v.shape == w.shape and (v == w).all(),
              f"{what}: save_state array {k}")


def _ingest_pipeline(plan, wl):
    from repro_torch.core import build_session
    from repro_torch.data import make_pipeline

    return make_pipeline(build_session(plan),
                         total_rows=N_INGEST_BATCHES * BATCH_ROWS,
                         batch_rows=BATCH_ROWS, seed=0, drift=wl.drift,
                         vocab_size=INGEST_VOCAB, **INGEST_LM)


def _checkpoint_roundtrip(st, directory):
    """A ``PipelineState`` through the port's checkpoints."""
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.data.pipeline import (state_from_checkpoint,
                                           state_to_checkpoint)

    tree, extra = state_to_checkpoint(st)
    save_checkpoint(directory, 3, tree, extra=extra)
    tree, extra, _ = load_checkpoint(directory, tree)
    return state_from_checkpoint(tree, extra)


class _TimedStream:
    """A ``LogStream`` in a pipeline, adding up on the host clock the time
    spent making its batches (``gen_s``)."""

    def __init__(self, stream):
        self.stream, self.gen_s = stream, 0.0

    @property
    def cursor(self) -> int:
        return self.stream.cursor

    def __iter__(self):
        it = iter(self.stream)
        while True:
            t0 = time.perf_counter()
            rb = next(it, None)
            self.gen_s += time.perf_counter() - t0
            if rb is None:
                return
            yield rb


def _same_lm_batch(got, want, what: str) -> None:
    import numpy as np

    for k in ("tokens", "labels"):
        check(got[k].dtype == np.int32 and got[k].shape == want[k].shape
              and np.array_equal(got[k], want[k]), f"{what}: {k} differ")


def _profiled(torch, fn, n: int, *, ops: bool = False):
    """The device kernels (``key_averages`` rows) of ``n`` calls of ``fn``
    under ``torch.profiler``; with ``ops``, also the trace's op events
    (``prof.events()``, input shapes recorded)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=ops) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    return (kernels, prof.events()) if ops else kernels


def _kernels_under(op) -> list:
    """The device kernels an op event and its children launched."""
    return list(op.kernels) + [k for ch in op.cpu_children
                               for k in _kernels_under(ch)]


def phase_ingest(torch, dev, runs, smi: str) -> None:
    """Phase 3c: the single-pass ingestion path (see the module doc)."""
    import tempfile

    import numpy as np

    from repro_torch.configs.paper_filters import PaperWorkload, filter_chain
    from repro_torch.core import FilterPlan, TokenizeSpec, build_session
    from repro_torch.data import tokenize_cases, tokenizer
    from repro_torch.kernels.filter_chain import filter_chain as fc

    n = N_INGEST_BATCHES
    log(f"== phase 3c: the ingestion path ({n} x {BATCH_ROWS} rows, paper "
        f"CNF chain, cuda, capacity=auto, TokenizeSpec({INGEST_VOCAB}, 8), "
        f"LM batches {INGEST_LM})")
    wl = PaperWorkload()
    spec = TokenizeSpec(INGEST_VOCAB, 8)

    def plan(tokenize):
        return FilterPlan(filter_chain("cnf"), wl.ordering, engine="cuda",
                          compact=True, capacity="auto", tokenize=tokenize)

    # the card's tokenize against the CPU's on the edge block
    cases = tokenize_cases.cases()
    for label, packed, counts, vocab, t in cases:
        packed, counts = torch.from_numpy(packed), torch.from_numpy(
            np.asarray(counts))
        want, want_n = tokenizer.tokens_from_padded(packed, counts, vocab, t)
        got, got_n = tokenizer.tokens_from_padded(packed.to(dev),
                                                  counts.to(dev), vocab, t)
        check(got.device.type == "cuda" and torch.equal(got.cpu(), want)
              and int(got_n) == int(want_n),
              f"tokens_from_padded on the card != on the CPU: {label}")
    log(f"  tokens_from_padded: card == CPU bit for bit on {len(cases)} edge "
        "cases (whole tensor and n_valid)")

    # (A) device tokenize: every LM batch kept; the state after 3 steps
    fc.reset_launch_counts()
    pipe = _ingest_pipeline(plan(spec), wl)
    pipe.stream = _TimedStream(pipe.stream)
    check(pipe._device_tokenize, "the tokenize plan's pipeline tokenizes "
          "on the host")
    lm, st, at, st_s = [], None, None, 0.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in pipe:
        lm.append(b)
        if st is None and pipe.stream.cursor == 3:
            t1 = time.perf_counter()
            st, at = pipe.state(), len(lm)
            st_s = time.perf_counter() - t1
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t0 - st_s
    launches = (fc.filter_chain_kernel.launches,
                fc.compact_gather_kernel.launches)
    check(launches == (n, n), f"ingestion launches (chain, gather) "
          f"{launches} != {(n, n)}")
    n_tok = pipe.batches_emitted * INGEST_LM["batch_size"] \
        * (INGEST_LM["seq_len"] + 1)
    check(len(lm) > 0 and pipe.rows_in == n * BATCH_ROWS,
          f"the pipeline emitted {len(lm)} batches over {pipe.rows_in} rows")

    # (B) host tokenize of the survivors: the same batches
    host = _ingest_pipeline(plan(None), wl)
    host.stream = _TimedStream(host.stream)
    check(not host._device_tokenize, "tokenize=None pipeline tokenizes on "
          "the device")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    i = 0
    for i, b in enumerate(host):
        check(i < len(lm), "the host-tokenize pipeline emitted more batches")
        _same_lm_batch(b, lm[i], f"device vs host tokenize, LM batch {i}")
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    check(i + 1 == len(lm) and host.rows_pass == pipe.rows_pass,
          f"host tokenize emitted {i + 1} batches, device {len(lm)}")
    log(f"  device tokenize == host tokenize on all {len(lm)} LM batches "
        f"({pipe.rows_pass} of {pipe.rows_in} rows kept); launches (chain, "
        f"gather) = {launches}")

    # restart: the state after 3 steps through a checkpoint
    with tempfile.TemporaryDirectory() as d:
        st = _checkpoint_roundtrip(st, d)
    fresh = _ingest_pipeline(plan(spec), wl)
    fresh.restore(st)
    # the restored buffer's batches, then two made of step 4's tokens
    per_batch = INGEST_LM["batch_size"] * (INGEST_LM["seq_len"] + 1)
    n_next = st.buffer.size // per_batch + 2
    got = [b for _, b in zip(range(n_next), fresh)]
    check(len(got) == n_next and at + n_next <= len(lm),
          f"the restart emitted {len(got)} of {n_next} batches")
    for j, b in enumerate(got):
        _same_lm_batch(b, lm[at + j], f"restart, LM batch {at + j}")
    check(fresh.stream.cursor == 4, "the restart did not run step 4")
    log(f"  restart after 3 steps through save_checkpoint/load_checkpoint: "
        f"the next {n_next} LM batches bit-identical, into step 4")

    # syncs per steady session.step: those of the plan without tokenize
    session = build_session(plan(spec))
    state, _, syncs, _ = _drive(torch, session, runs["batches"][:n],
                                record=False, count_syncs=True)
    want = runs["auto"]["cuda"]["syncs"][:n - 1]
    check(syncs == want, f"tokenize plan syncs per steady step {syncs} != "
          f"{want} without tokenize")
    log(f"  syncs per steady step {syncs}, as without tokenize")

    # numbers: the tokenize stage within a steady step
    cols = runs["batches"][n - 1]
    state, res = session.step(state, cols)
    packed, n_kept = res.packed, res.n_kept
    ms = _device_ms(torch, lambda: tokenizer.tokens_from_padded(
        packed, n_kept, INGEST_VOCAB, 8), [()], 10)
    tok = _profiled(torch, lambda: tokenizer.tokens_from_padded(
        packed, n_kept, INGEST_VOCAB, 8), 4)
    holder = [state]

    def step():
        holder[0], _ = session.step(holder[0], cols)

    stp = _profiled(torch, step, 4)
    tok_us = sum(e.self_device_time_total for e in tok) / 4
    tok_k = sum(e.count for e in tok) / 4
    step_us = sum(e.self_device_time_total for e in stp) / 4
    step_k = sum(e.count for e in stp) / 4
    share = f"{tok_us / step_us:.1%}" if step_us > 0 else "not measured"
    log(f"  tokenize stage ({smi}): {tok_us:.1f} us of device time and "
        f"{tok_k:.0f} kernels per step under the profiler, {ms:.4f} ms per "
        f"call by CUDA events, at capacity {res.capacity} with "
        f"{int(n_kept)} rows kept; the whole step {step_us:.1f} us and "
        f"{step_k:.0f} kernels; tokenize's share of the step's device time: "
        f"{share}")
    log(f"  pipeline ({smi}), host clock over {n} steps: device tokenize "
        f"{n * BATCH_ROWS / dev_s:,.0f} rows/s, {n_tok / dev_s:,.0f} "
        f"tokens/s ({dev_s:.2f} s); host tokenize "
        f"{n * BATCH_ROWS / host_s:,.0f} rows/s, {n_tok / host_s:,.0f} "
        f"tokens/s ({host_s:.2f} s); stream generation on the host included")
    dev_g, host_g = pipe.stream.gen_s, host.stream.gen_s
    log(f"  stream generation ({smi}), host clock inside those loops: "
        f"device tokenize {dev_g:.3f} s of {dev_s:.3f} s "
        f"({dev_g / dev_s:.1%}), {dev_g / n * 1e3:.1f} ms a batch, the rest "
        f"{(dev_s - dev_g) / n * 1e3:.1f} ms a step; host tokenize "
        f"{host_g:.3f} s of {host_s:.3f} s ({host_g / host_s:.1%}), the "
        f"rest {(host_s - host_g) / n * 1e3:.1f} ms a step")


# ===================================================================== 4
def _device_ms(torch, fn, arg_sets, iters: int) -> float:
    """Device time per call: the launches queue up behind a sleep kernel,
    so the events time the device, not the host's enqueue pace."""
    fn(*arg_sets[0])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _ops_per_row(pred) -> int:
    from repro_torch.core import predicates as P

    return {P.OP_GT: 1, P.OP_LT: 1, P.OP_BETWEEN: 2, P.OP_EQ: 3}.get(
        pred.op, 6 * max(pred.rounds, 1) + 1)


def _bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _chain_split(torch, dev, batches, chain, perm, ms_a: float) -> None:
    """The mask-only chain kernel's time split by varying its inputs on
    the same batches: (a) as on the main path, (b) with no sampled row,
    (c) with HASHMIX cut to one round (same threshold, so every position
    before it sees the same pending rows), (d) ``int_hi`` alone, beside a
    one-pass PyTorch compare that streams the same column into a mask."""
    import dataclasses

    from repro_torch.core import pack
    from repro_torch.core import predicates as P
    from repro_torch.kernels.filter_chain import filter_chain as fc
    from repro_torch.kernels.filter_chain import ops

    rows = BATCH_ROWS
    specs = pack(chain, dev)
    meta = ops._pack_meta(rows, 1000, 0, "row", dev)
    # (gidx + 1) % 2^30 == 0 for no row below 2^30 - 1
    no_mon = ops._pack_meta(rows, 1 << 30, 1, "row", dev)
    one = pack([dataclasses.replace(p, rounds=1) if p.op == P.OP_HASHMIX
                else p for p in chain], dev)
    hi = next(i for i, p in enumerate(chain) if p.name == "int_hi")
    alone = pack([chain[hi]], dev)
    first = torch.zeros(1, dtype=torch.int32, device=dev)

    def run(sp, pm, m):
        return _device_ms(torch, lambda b: fc.filter_chain_kernel(b, sp, pm,
                                                                  m),
                          [(b,) for b in batches], 40)

    col, t1 = chain[hi].column, alone.t1[0]
    lines = [
        ("(a) as on the main path", ms_a),
        ("(b) monitor lane empty", run(specs, perm, no_mon)),
        ("(c) HASHMIX cut to 1 round", run(one, perm, meta)),
        ("(d) int_hi alone", run(alone, first, meta)),
        ("(d) yardstick (col > t).to(int8)", _device_ms(
            torch, lambda b: (b[col] > t1).to(torch.int8),
            [(b,) for b in batches], 40)),
    ]
    for label, ms in lines:
        log(f"  split {label}: {ms:.4f} ms ({ms / ms_a:.1%} of (a))")


def _gather_split(torch, dev, packs, cap: int, ms_a: float) -> dict:
    """``compact_gather_kernel``'s time split by its inputs on the same
    packs (the chain kernel's, of 4 paper batches): (a) as on the main
    path; (b) copy only, capacity = n_kept of each batch, so no fill;
    (c) fill only, counts and offsets zero, so all of [C, cap] is fill;
    (d) the write yardstick ``torch.empty(C, cap).fill_(0.0)``, one
    PyTorch call writing the same bytes (timed here, never called by the
    port); then a saturating and a lossless capacity. Each with batch 0's
    rows kept and its byte bound: survivors read and [C, cap] written once,
    plus the per-tile offsets and counts."""
    from repro_torch.kernels.filter_chain import filter_chain as fc

    n_cols, n_rows_p = packs[0][0].shape
    tile_bytes = 2 * 4 * (n_rows_p // fc.DEFAULT_TILE)
    total = int(packs[0][2].sum())

    def row(ms, kept, capacity, extra=tile_bytes):
        bound = _bound(n_cols * (kept + capacity) * 4 + extra, 0)[0]
        return dict(ms=ms, bound_ms=bound, kept=kept, capacity=capacity)

    def kernel(sets):
        return _device_ms(torch, fc.compact_gather_kernel, sets, 40)

    zero = torch.zeros_like(packs[0][2])
    split = {
        "a": row(ms_a, min(total, cap), cap),
        "b": row(kernel([(p, o, c, int(c.sum())) for p, o, c in packs]),
                 total, total),
        "c": row(kernel([(p, zero, zero, cap) for p, _, _ in packs]), 0,
                 cap),
        "d": row(_device_ms(torch, lambda: torch.empty(
            n_cols, cap, device=dev).fill_(0.0), [()], 40), 0, cap, 0),
    }
    for capacity in (262_144, 524_288):
        split[f"capacity {capacity}"] = row(
            kernel([(p, o, c, capacity) for p, o, c in packs]),
            min(total, capacity), capacity)
    names = {"a": "(a) as on the main path", "b": "(b) copy only",
             "c": "(c) fill only", "d": "(d) yardstick empty().fill_()"}
    for key, r in split.items():
        log(f"  gather split {names.get(key, key)}: {r['ms']:.4f} ms "
            f"({r['ms'] / ms_a:.1%} of (a)); capacity {r['capacity']}, "
            f"{r['kept']} kept; bound {r['bound_ms']:.4f} ms "
            f"({r['bound_ms'] / r['ms']:.1%} of bound)")
    return split


def phase_numbers(torch, dev, runs, errs) -> list:
    from repro_torch.configs.paper_filters import filter_chain
    from repro_torch.core import pack
    from repro_torch.kernels.filter_chain import filter_chain as fc
    from repro_torch.kernels.filter_chain import ops

    log(f"== phase 4: numbers on {torch.cuda.get_device_name(0)}")
    chain = filter_chain("cnf")
    specs = pack(chain, dev)
    perm = runs["off"]["cuda"]["state"].perm.contiguous()
    batches = runs["batches"][:4]          # 4 x 48 MiB: beyond the 50 MB L2
    metas = [ops._pack_meta(BATCH_ROWS, 1000, 0, "row", dev)] * len(batches)
    n_cols = batches[0].shape[0]
    rows = BATCH_ROWS

    def chain_args(compact):
        return [(b, specs, perm, m) for b, m in zip(batches, metas)], \
            dict(compact=compact)

    out = []
    # data-dependent operation count of batch 0 in the timed order
    mask_i8, active, *_ = fc.filter_chain_kernel(batches[0], specs, perm,
                                                 metas[0])
    alive = active.sum(dim=0).tolist()
    n_surv = int(mask_i8.sum())
    log(f"  batch 0, order {[chain[p].name for p in perm.tolist()]}: rows "
        f"pending at each position {[int(a) for a in alive]}; "
        f"{n_surv} survivors")
    n_sampled = rows // 1000 + 1
    ops_chain = sum(a * _ops_per_row(chain[p]) for a, p in
                    zip(alive, perm.tolist())) \
        + n_sampled * sum(_ops_per_row(p) for p in chain)
    for compact, label, launches in (
            (False, "filter_chain", runs["off"]["cuda"]["launches"][0]),
            (True, "filter_chain[compact]",
             runs["auto"]["cuda"]["launches"][0])):
        args, kw = chain_args(compact)
        ms = _device_ms(torch, lambda *a: fc.filter_chain_kernel(*a, **kw),
                        args, 40)
        plain = _device_ms(torch, lambda *a: fc.filter_chain_twin(*a, **kw),
                           args, 4)
        # two byte counts: every column read once (the earlier yardstick), and
        # what this batch needs — of each column the rows pending at the
        # positions that read it (the most at any one of them, a lower
        # bound on their union), the sampled rows, and with the pack every
        # column of the survivors; plus the mask, the packed buffer and
        # the per-tile counts
        packed = (n_cols * rows * 4 + 4 * (rows // fc.DEFAULT_TILE)
                  if compact else 0)
        every = n_cols * rows * 4 + rows + packed
        need = {}
        for a, p in zip(alive, perm.tolist()):
            c = chain[p].column
            need[c] = max(need.get(c, 0), a, n_sampled)
        if compact:
            need = {c: max(need.get(c, 0), n_surv) for c in range(n_cols)}
        moved = sum(need.values()) * 4 + rows + packed
        bound_ms, bound_by = _bound(moved, ops_chain)
        every_ms = _bound(every, ops_chain)[0]
        out.append(dict(name=label, route="cuda", source=SOURCE,
                        replaces=f"{TPU_SOURCE}:156", launches=launches,
                        max_abs_err=errs["chain"], ms=ms, plain_ms=plain,
                        bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=None, bound_ms_every_column=every_ms))
        log(f"  {label}: {ms:.4f} ms/launch; bound {bound_ms:.4f} ms by "
            f"{bound_by} from the pending rows ({moved / 2**20:.1f} MiB, "
            f"{ops_chain:,.0f} ops; {bound_ms / ms:.1%} of bound), "
            f"{every_ms:.4f} ms from every column ({every / 2**20:.1f} MiB; "
            f"{every_ms / ms:.1%}); twin {plain:.4f} ms")
        if not compact:
            _chain_split(torch, dev, batches, chain, perm, ms)

    # gather at the stream's auto capacity, and its time split by inputs
    cap = runs["auto"]["cuda"]["steps"][-1]["capacity"]
    packs = []
    for b, m in zip(batches, metas):
        *_, packed, cnt = fc.filter_chain_kernel(b, specs, perm, m,
                                                 compact=True)
        cnt = cnt[:, 0]
        packs.append((packed, torch.cumsum(cnt, 0, dtype=torch.int32) - cnt,
                      cnt))
    gather_sets = [(p, o, c, cap) for p, o, c in packs]
    masks = [(b, fc.filter_chain_kernel(b, specs, perm, m)[0][0].bool())
             for b, m in zip(batches, metas)]
    ms = _device_ms(torch, fc.compact_gather_kernel, gather_sets, 40)
    plain = _device_ms(torch, fc.compact_gather_twin, gather_sets, 4)
    library = _device_ms(torch, lambda b, m: b[:, m], masks, 8)
    split = _gather_split(torch, dev, packs, cap, ms)
    bound_ms = split["a"]["bound_ms"]
    out.append(dict(name="compact_gather", route="cuda", source=SOURCE,
                    replaces=f"{TPU_SOURCE}:372",
                    launches=runs["auto"]["cuda"]["launches"][1],
                    max_abs_err=errs["gather"], ms=ms, plain_ms=plain,
                    bound_ms=bound_ms, bound_by="bytes",
                    library_ms=library, split=split))
    log(f"  compact_gather: {ms:.4f} ms/launch at capacity {cap} "
        f"({split['a']['kept']} survivors kept; bound {bound_ms:.4f} ms by "
        f"bytes, {bound_ms / ms:.1%} of bound); twin {plain:.4f} ms; "
        f"boolean-mask index {library:.4f} ms")
    for label in ("off", "auto"):
        for engine in ("cuda", "torch"):
            r = runs[label][engine]
            log(f"  end to end engine={engine} compact={label}: "
                f"{N_BATCHES * BATCH_ROWS / r['seconds']:,.0f} rows/s; "
                f"syncs per steady step max {max(r['syncs'])}")
            _profile_steps(torch, r["session"].plan, runs["batches"],
                           r["seconds"] / N_BATCHES)
    out += _skip_numbers(torch, dev, runs["skip"], errs, specs)
    return out


def _skip_numbers(torch, dev, sk, errs, specs) -> list:
    """Times of the stats kernel and the skip chain kernel on the clustered
    batches, and the skip plans end to end."""
    from repro_torch.kernels.filter_chain import filter_chain as fc
    from repro_torch.kernels.filter_chain import ops

    out = []
    batches = sk["batches"][:4]            # 4 x 48 MiB: beyond the 50 MB L2
    n_cols, rows = batches[0].shape
    n_sub = rows // fc.STAT_TILE
    sets = [(b,) for b in batches]
    ms = _device_ms(torch, fc.tile_stats_kernel, sets, 40)
    plain = _device_ms(torch, fc.tile_stats_twin, sets, 4)
    library = _device_ms(
        torch, lambda b: torch.aminmax(b.view(n_cols, n_sub, fc.STAT_TILE),
                                       dim=-1), sets, 40)
    moved = n_cols * rows * 4 + 2 * n_cols * n_sub * 4
    bound_ms, bound_by = _bound(moved, 2 * n_cols * rows)
    out.append(dict(name="tile_stats", route="cuda", source=SOURCE,
                    replaces=f"{TPU_SOURCE}:75",
                    launches=sk[("a", "cuda")]["launches"]["stats"],
                    max_abs_err=errs["stats"], ms=ms, plain_ms=plain,
                    bound_ms=bound_ms, bound_by=bound_by,
                    library_ms=library))
    log(f"  tile_stats: {ms:.4f} ms/launch (bound {bound_ms:.4f} ms by "
        f"{bound_by}, {moved / 2**20:.2f} MiB; {bound_ms / ms:.1%} of "
        f"bound); twin {plain:.4f} ms; torch.aminmax {library:.4f} ms")

    # the skip chain kernel with the clustered batches' own triage, in the
    # order plan (a) ended with
    perm = sk[("a", "cuda")]["state"].perm.contiguous()
    metas = [ops._pack_meta(rows, 1000, 0, "row", dev)] * len(batches)
    decs = []
    for b in batches:
        info = ops.skip_triage(b, specs, bloom=False)
        decs.append((info.pass_tiles.to(torch.int32),
                     info.fail_tiles.to(torch.int32)))
    args = [(b, specs, perm, m, d) for b, m, d in zip(batches, metas, decs)]
    ms = _device_ms(torch, lambda b, s, p, m, d: fc.filter_chain_kernel(
        b, s, p, m, skip_decisions=d), args, 40)
    plain = _device_ms(torch, lambda b, s, p, m, d: fc.filter_chain_twin(
        b, s, p, m, skip_decisions=d), args, 4)
    no_skip = _device_ms(torch, lambda b, s, p, m, d: fc.filter_chain_kernel(
        b, s, p, m), args, 40)
    # what this run's data needs: of each column, the rows pending at the
    # positions that read it (the most pending at any one of them, a lower
    # bound on their union) and the sampled rows of decided sub-tiles; the
    # decisions; the mask. Beside it, every column of every ambiguous
    # sub-tile, which is what the tier alone leaves to read.
    pas, fail = decs[0]
    decided = (pas | fail) > 0
    sampled = torch.arange(0, rows, 1000, device=dev)
    n_amb = int((~decided).sum())
    n_samp_decided = int(decided[sampled // fc.STAT_TILE].sum())
    _, active, *_ = fc.filter_chain_kernel(batches[0], specs, perm, metas[0],
                                           skip_decisions=decs[0])
    chain = [p for p in sk[("a", "cuda")]["plan"].predicates]
    alive = active.sum(dim=0).tolist()
    col_rows = {}
    for a, p in zip(alive, perm.tolist()):
        col_rows[chain[p].column] = max(col_rows.get(chain[p].column, 0), a)
    fixed = 2 * 4 * n_sub + rows
    moved = (sum(col_rows.values()) + n_samp_decided * n_cols) * 4 + fixed
    moved_tiles = (n_amb * fc.STAT_TILE + n_samp_decided) * n_cols * 4 + fixed
    ops_skip = sum(a * _ops_per_row(chain[p]) for a, p in
                   zip(alive, perm.tolist())) \
        + (rows // 1000 + 1) * sum(_ops_per_row(p) for p in chain)
    bound_ms, bound_by = _bound(moved, ops_skip)
    every_ms = _bound(moved_tiles, ops_skip)[0]
    out.append(dict(name="filter_chain[skip]", route="cuda", source=SOURCE,
                    replaces=f"{TPU_SOURCE}:164",
                    launches=sk[("a", "cuda")]["launches"]["skip"],
                    max_abs_err=errs["skip"], ms=ms, plain_ms=plain,
                    bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                    bound_ms_every_column=every_ms))
    log(f"  filter_chain[skip]: {ms:.4f} ms/launch on clustered batches "
        f"({n_amb} of {n_sub} sub-tiles ambiguous in batch 0; pending rows "
        f"{[int(a) for a in alive]}; bound {bound_ms:.4f} ms by {bound_by}, "
        f"{moved / 2**20:.2f} MiB of pending rows, {ops_skip:,.0f} ops; "
        f"{bound_ms / ms:.1%} of bound; every column of the ambiguous "
        f"sub-tiles would be {moved_tiles / 2**20:.2f} MiB, "
        f"{every_ms:.4f} ms); twin {plain:.4f} ms; "
        f"the same kernel without decisions {no_skip:.4f} ms")

    for key, r in sk.items():
        if key == "batches":
            continue
        log(f"  end to end plan ({key[0]}) engine={key[1]} "
            f"skip_tier={r['plan'].skip_tier}: "
            f"{N_SKIP_BATCHES * BATCH_ROWS / r['seconds']:,.0f} rows/s; "
            f"syncs per steady step max {max(r['syncs'])}")
    _paired_rates(torch, sk[("d", "cuda")]["plan"], sk[("a", "cuda")]["plan"],
                  sk["batches"])
    for key in (("a", "cuda"), ("a", "torch"), ("d", "cuda"), ("d", "torch")):
        r = sk[key]
        log(f"  profile plan ({key[0]}) engine={key[1]}:")
        _profile_steps(torch, r["plan"], sk["batches"],
                       r["seconds"] / N_SKIP_BATCHES)
    return out


def _paired_rates(torch, off_plan, on_plan, batches, pairs: int = PAIRS):
    """End-to-end rows/s of the tier off vs on, in ``pairs`` alternating
    pairs (off first in even pairs, on first in odd ones) on one card:
    medians, quartiles, and how many pairs the tier won."""
    import numpy as np

    from repro_torch.core import build_session

    rates = {"off": [], "on": []}
    for i in range(pairs):
        order = (("off", off_plan), ("on", on_plan))
        for label, plan in (order if i % 2 == 0 else order[::-1]):
            _, _, _, seconds = _drive(torch, build_session(plan), batches,
                                      record=False, count_syncs=False)
            rates[label].append(len(batches) * BATCH_ROWS / seconds)
    wins = sum(a > b for a, b in zip(rates["on"], rates["off"]))
    q = {k: np.percentile(v, [25, 50, 75]) for k, v in rates.items()}
    log(f"  paired end to end, engine={on_plan.engine}, "
        f"skip_tier={on_plan.skip_tier} vs off, {pairs} pairs: on median "
        f"{q['on'][1]:,.0f} rows/s (quartiles {q['on'][0]:,.0f} - "
        f"{q['on'][2]:,.0f}), off median {q['off'][1]:,.0f} (quartiles "
        f"{q['off'][0]:,.0f} - {q['off'][2]:,.0f}); the tier won {wins} of "
        f"{pairs} pairs")


def _profile_steps(torch, plan, batches, step_s: float, n: int = 4) -> None:
    """Device kernels per steady step, under torch.profiler, beside the
    unprofiled step time: how much of a step the device is busy."""
    from repro_torch.core import build_session

    session = build_session(plan)
    holder = [session.step(session.init_state(), batches[0])[0]]
    steps = iter(batches[1:n + 1])

    def step():
        holder[0], _ = session.step(holder[0], next(steps))

    kernels = _profiled(torch, step, n)
    busy_us = sum(getattr(e, "self_device_time_total", 0.0) for e in kernels)
    count = sum(e.count for e in kernels)
    if not kernels or busy_us <= 0.0:
        log("    profiler: no device time recorded")
        return
    per_step = busy_us / n
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    log(f"    profiler: {count / n:.0f} device kernels and {per_step:.1f} "
        f"us of device time per step = {per_step / (step_s * 1e6):.1%} of "
        f"the unprofiled step ({step_s * 1e3:.3f} ms); top: " + "; ".join(
            f"{e.key[:40]} {e.self_device_time_total / n:.1f} us"
            for e in top))


# ===================================================================== 5
N_SOAK_BATCHES = 12            # the chaos soak: the paper stream's first 12
GUARD_CAPACITY = 1_048_576     # bounded compaction: only the storm overflows
SOAK_FAULTS = dict(poison=(2, 9), storm=(6,), kill=(4,), corrupt=(8,))
#: the corruption the soak injects: every 2^22-row batch crosses an epoch
#: boundary, which zeroes num_cut (so "nan_stat" heals within the step,
#: and the CNF ranks read group_cut); an infinite cost reaches the ranks
SOAK_CORRUPTION = "inf_stat"
N_LADDER_STEPS = 12            # the clustered batches, cycled
SERVE_REQUESTS = (4096, 65_536)


def _guard_plan(**kw):
    from repro_torch.configs.paper_filters import PaperWorkload, filter_chain
    from repro_torch.core import FilterPlan

    return FilterPlan(filter_chain("cnf"), PaperWorkload().ordering,
                      engine="cuda", compact=True, capacity=GUARD_CAPACITY,
                      **kw)


def _launch_counts() -> dict:
    from repro_torch.kernels.filter_chain import filter_chain as fc

    return fc.launch_counts()


def _masks(torch, plan, batches) -> list:
    """The unguarded ``cuda`` session's masks over the batches."""
    from repro_torch.core import build_session

    session = build_session(plan)
    state, masks = session.init_state(), []
    for cols in batches:
        state, res = session.step(state, cols)
        masks.append(res.mask)
    return masks


def phase_guarded(torch, dev, runs, smi: str) -> None:
    """Phase 5: the guarded serving path (see the module docstring)."""
    log("== phase 5: the guarded serving path (GuardedSession, the fault "
        "toolkit, the admission server)")
    t0 = time.perf_counter()
    host = [b.cpu().numpy() for b in runs["batches"][:N_SOAK_BATCHES]]
    _guarded_soak(torch, runs["batches"][:N_SOAK_BATCHES], host, smi)
    _guarded_ladder(torch, runs["skip"]["batches"], smi)
    _guard_syncs_and_pairs(torch, runs["batches"][:N_SOAK_BATCHES], host,
                           smi)
    _serve_runs(torch, smi)
    log(f"  phase 5 took {time.perf_counter() - t0:.1f} s ({smi})")


def _guarded_soak(torch, dev_batches, host, smi: str) -> None:
    """(a) The chaos soak at full width: host batches through a
    ``RequestStream`` under ``run_log_stream``, two poisoned, one storm,
    one killed step and one corrupted state; clean batches bit-identical
    to the unguarded ``cuda`` run, every recovery counted."""
    from repro_torch.core import build_session
    from repro_torch.data.stream import RequestStream
    from repro_torch.kernels.filter_chain import filter_chain as fc
    from repro_torch.runtime import (DataFaultInjector, FailureInjector,
                                     GuardedSession, GuardPolicy,
                                     corrupt_state)

    n, f = len(host), SOAK_FAULTS
    plan = _guard_plan()
    base = _masks(torch, plan, dev_batches)
    survivor = int(torch.nonzero(base[0])[0])
    inj = DataFaultInjector(poison_at=f["poison"], storm_at=f["storm"],
                            storm_row=host[0][:, survivor])
    kill = FailureInjector(f["kill"])

    def state_inj(i, st):
        return corrupt_state(st, SOAK_CORRUPTION) if i in f["corrupt"] \
            else st

    guard = GuardedSession(build_session(plan),
                           GuardPolicy(validate_every=1, checkpoint_every=4),
                           step_injector=kill.maybe_fail,
                           state_injector=state_inj)
    stream = RequestStream(lambda b, start, rows: host[b],
                           total_rows=n * BATCH_ROWS, batch_rows=BATCH_ROWS)
    fc.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, results = guard.run_log_stream(stream, batch_hook=inj)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launch_counts()

    check(sorted(results) == list(range(n)), f"soak results {sorted(results)}")
    kept = []
    for b, res in results.items():
        if b in f["poison"]:
            check(res.quarantined and not bool(res.mask.any()),
                  f"soak: poisoned batch {b} not quarantined")
        elif b in f["storm"]:
            check(not res.quarantined and res.n_pass == BATCH_ROWS,
                  f"soak: the storm batch kept {res.n_pass} of {BATCH_ROWS}")
        else:
            check(not res.quarantined and torch.equal(res.mask, base[b]),
                  f"soak: clean batch {b} differs from the unguarded run")
            kept.append(res.n_pass)
    h = guard.health
    check(h.quarantined == len(f["poison"]) and h.overflow_events == 1
          and h.retries >= 1 and h.validator_failures >= 1
          and h.rollbacks >= 1, f"soak health {h.summary()}")
    check([e["changes"] for e in h.degrades] == [{"capacity": "None"}],
          f"soak degraded other than the storm's capacity rung: "
          f"{h.degrades}")
    check(guard.session.plan.engine == "cuda"
          and guard.session.validate_state(state),
          "soak: final state invalid or engine left cuda")
    check(launches["chain"] >= n and launches["gather"] >= n,
          f"soak launches {launches}")
    log(f"  (a) chaos soak, {n} host batches x {BATCH_ROWS} rows, capacity "
        f"{GUARD_CAPACITY}, faults {f}, corruption {SOAK_CORRUPTION!r}: "
        f"{seconds:.2f} s ({smi}); clean "
        f"batches == unguarded cuda run, kept {min(kept)}-{max(kept)}; the "
        f"storm kept all {BATCH_ROWS} rows; guard[{h.summary()}] "
        f"validator_failures={h.validator_failures}; degrades "
        f"{[e['changes'] for e in h.degrades]}; launches {launches}")


def _guarded_ladder(torch, clustered, smi: str) -> None:
    """(b) The ladder on the card: a fault that fails six step attempts
    walks cuda → torch, zonemap → off and fused → mask compaction; once it
    clears, promote_after=2 climbs back to the kernels. Then a fault-free
    guarded run: zero degrades."""
    from repro_torch.core import build_session
    from repro_torch.kernels.filter_chain import filter_chain as fc
    from repro_torch.runtime import GuardedSession, GuardPolicy

    plan = _guard_plan(skip_tier="zonemap")
    seq = [clustered[i % len(clustered)] for i in range(N_LADDER_STEPS)]
    want = _masks(torch, plan, seq)
    fault = {"left": 6}

    def injector(i):
        if i >= 1 and fault["left"] > 0:
            fault["left"] -= 1
            raise RuntimeError("injected device fault")

    fc.reset_launch_counts()
    guard = GuardedSession(
        build_session(plan),
        GuardPolicy(max_retries=1, validate_every=1, promote_after=2),
        step_injector=injector)
    state, at_top = guard.init_state(), None
    for i, (cols, mask) in enumerate(zip(seq, want)):
        before = _launch_counts()
        state, res = guard.step(state, cols)
        check(torch.equal(res.mask, mask), f"ladder: mask differs, step {i}")
        check(guard.session.device.type == "cuda",
              f"ladder: the session left the card at step {i}")
        if i == 1:
            check(guard.session.plan.engine == "torch"
                  and _launch_counts() == before,
                  "ladder: the bottom rung launched a kernel")
        if at_top is None and len(guard.health.promotes) == 3:
            at_top = (i, _launch_counts())
    h = guard.health
    down = [{"engine": "torch"}, {"skip_tier": "off"},
            {"compact": "False", "capacity": "None"}]
    up = [{"compact": "True", "capacity": str(GUARD_CAPACITY)},
          {"skip_tier": "zonemap"}, {"engine": "cuda"}]
    check([e["changes"] for e in h.degrades] == down
          and [e["changes"] for e in h.promotes] == up,
          f"ladder: degrades {h.degrades}, promotes {h.promotes}")
    rungs = guard.health_snapshot()["rungs"]
    check(rungs == {"engine": "cuda", "skip_tier": "zonemap",
                    "compact": True, "capacity": str(GUARD_CAPACITY),
                    "degrade_depth": 0}, f"ladder: final rungs {rungs}")
    end = _launch_counts()
    check(at_top is not None and all(end[k] > at_top[1][k] for k in end),
          f"ladder: kernels not launched after the last promotion "
          f"({at_top} -> {end})")
    log(f"  (b) ladder, {N_LADDER_STEPS} clustered steps from "
        f"cuda/zonemap/{GUARD_CAPACITY}: degrades at steps "
        f"{[e['step'] for e in h.degrades]} {[e['changes'] for e in h.degrades]}"
        f", promotes at steps {[e['step'] for e in h.promotes]}; masks == "
        f"unguarded; launches at the last promotion (after step "
        f"{at_top[0]}) {at_top[1]}, at the end {end}")

    fc.reset_launch_counts()
    clean = GuardedSession(build_session(plan),
                           GuardPolicy(validate_every=1, promote_after=2))
    state = clean.init_state()
    for i, (cols, mask) in enumerate(zip(seq, want)):
        state, res = clean.step(state, cols)
        check(torch.equal(res.mask, mask), f"fault-free guarded: mask, "
              f"step {i}")
    launches = _launch_counts()
    h = clean.health
    check(h.degrades == [] and h.promotes == [] and h.retries == 0
          and h.overflow_events == 0,
          f"a fault-free guarded run degraded: {h.summary()} {h.degrades}")
    check(all(v == N_LADDER_STEPS for v in launches.values()),
          f"fault-free guarded launches {launches}")
    log(f"  (b) fault-free guarded run: guard[{h.summary()}], launches "
        f"{launches}")


def _guard_syncs_and_pairs(torch, dev_batches, host, smi: str) -> None:
    """Syncs per steady guarded step against the unguarded step's, on
    device-resident and host batches; the host finite check's own time;
    guarded vs unguarded rows/s in alternating pairs."""
    import numpy as np

    from repro_torch.core import build_session
    from repro_torch.core.session import fstate_to_arrays
    from repro_torch.runtime import GuardedSession, GuardPolicy

    plan = _guard_plan()
    pol = GuardPolicy(validate_every=4, checkpoint_every=8)
    n_arrays = len(fstate_to_arrays(build_session(plan).init_state()))
    for feed, batches in (("device", dev_batches), ("host", host)):
        sites: set = set()
        _, _, plain, _ = _drive(torch, build_session(plan), batches,
                                record=False, count_syncs=True)
        guard = GuardedSession(build_session(plan), pol)
        _, _, guarded, _ = _drive(torch, guard, batches, record=False,
                                  count_syncs=True, sync_sites=sites)
        check(guard.health.degrades == [] and guard.health.retries == 0,
              f"a fault-free guarded run degraded: {guard.health.degrades}")
        # per steady step i (i >= 1, so step index i + 1 after it): the
        # admission check on a tensor, the overflow read, the validator
        # every validate_every, save_state's reads every checkpoint_every
        want = [(feed == "device") + 1
                + ((i + 1) % pol.validate_every == 0)
                + n_arrays * ((i + 1) % pol.checkpoint_every == 0)
                for i in range(1, len(batches))]
        extra = [g - p for g, p in zip(guarded, plain)]
        log(f"  syncs per steady step, {feed}-fed, validate_every="
            f"{pol.validate_every}, checkpoint_every={pol.checkpoint_every}: "
            f"guarded {guarded}, unguarded {plain}; the guard's {extra}, "
            f"budget {want}")
        for site in sorted(sites)[:12]:
            log(f"    sync at {site}")
        check(extra == want, f"{feed}-fed guarded syncs {extra} != budget "
              f"{want}")

    fin = []
    for b in host:
        t0 = time.perf_counter()
        check(bool(np.isfinite(b).all()), "a stream batch is not finite")
        fin.append((time.perf_counter() - t0) * 1e3)
    log(f"  host np.isfinite(cols).all() on a {BATCH_ROWS} x 3 f32 batch "
        f"({smi}): median {np.median(fin):.2f} ms, min {min(fin):.2f}, "
        f"max {max(fin):.2f}")
    dev_fin = _device_ms(torch, lambda b: torch.isfinite(b).all(),
                         [(b,) for b in dev_batches[:4]], 40)
    log(f"  device torch.isfinite(cols).all() ({smi}): {dev_fin:.4f} ms "
        f"by CUDA events (before its one read)")

    for feed, batches in (("host", host), ("device", dev_batches)):
        rates = {"unguarded": [], "guarded": []}
        for i in range(PAIRS):
            order = [("unguarded", lambda: build_session(plan)),
                     ("guarded", lambda: GuardedSession(build_session(plan)))]
            for label, make in (order if i % 2 == 0 else order[::-1]):
                _, _, _, seconds = _drive(torch, make(), batches,
                                          record=False, count_syncs=False)
                rates[label].append(len(batches) * BATCH_ROWS / seconds)
        q = {k: np.percentile(v, [25, 50, 75]) for k, v in rates.items()}
        ms = {k: len(batches) * BATCH_ROWS / np.array(v) * 1e3 / len(batches)
              for k, v in rates.items()}
        log(f"  paired {feed}-fed, GuardPolicy() vs unguarded, {PAIRS} "
            f"pairs ({smi}): guarded median {q['guarded'][1]:,.0f} rows/s "
            f"(quartiles {q['guarded'][0]:,.0f} - {q['guarded'][2]:,.0f}), "
            f"unguarded median {q['unguarded'][1]:,.0f} (quartiles "
            f"{q['unguarded'][0]:,.0f} - {q['unguarded'][2]:,.0f}); ms a "
            f"step guarded {np.round(ms['guarded'], 2).tolist()}, "
            f"unguarded {np.round(ms['unguarded'], 2).tolist()}")


def _serve_runs(torch, smi: str) -> None:
    """(c) The admission server through the serve CLI at its defaults on
    the card, the same on the CPU, and at 65,536 requests on the card."""
    import tempfile

    from repro_torch.launch import serve

    argv = ["--guarded"]
    with tempfile.TemporaryDirectory() as d:
        card = serve.run(argv + ["--bench-out", f"{d}/serve.json"])
        check(Path(d, "serve.json").is_file(), "--bench-out wrote nothing")
        cpu = serve.run(argv + ["--device", "cpu"])
        big = serve.run(argv + ["--requests", str(SERVE_REQUESTS[1])])
    for label, r, n in (("card", card, SERVE_REQUESTS[0]),
                        ("cpu", cpu, SERVE_REQUESTS[0]),
                        ("65536", big, SERVE_REQUESTS[1])):
        p = r.payload
        check(r.rc == 0 and p["parity"]["ok"],
              f"serve {label}: rc {r.rc}, parity {p['parity']}")
        check(p["guard"]["degrades"] == [] and p["quarantined"] == 0,
              f"serve {label}: guard {p['guard']}")
        # the served path's own launches: one chain launch a micro-batch
        # and one for the warmup on the card, none of the twins' on the CPU
        want = n // 64 + 1 if label != "cpu" else 0
        check(p["launches"] == dict(chain=want, skip=0, gather=0, stats=0),
              f"serve {label}: launches {p['launches']}, want chain {want}")
    check(card.payload["config"]["device"].startswith("cuda")
          and cpu.payload["config"]["device"] == "cpu",
          "serve: the runs' devices")
    same = serve._parity(card.report, cpu.report.masks,
                         cpu.report.state_blob)
    check(same["ok"], f"serve: the card != the CPU ({same})")
    for label, r in (("card, 4096", card), ("card, 65536", big),
                     ("cpu, 4096", cpu)):
        m = r.payload
        lat = m["admission_latency_ms"]
        gate_s = m["gate_us_per_request"] * m["decided"] / 1e6
        ref_ms = m["parity"]["reference_s"] / m["batches"] * 1e3
        log(f"  (c) serve {label} requests ({smi}): "
            f"{m['requests_per_sec']:,.0f} req/s, p50 {lat['p50']:.3f} ms, "
            f"p99 {lat['p99']:.3f} ms, wall {m['wall_s']:.3f} s, slot "
            f"occupancy {m['slot_occupancy']:.3f}; the gate "
            f"{m['gate_us_per_request']:.2f} us/request, "
            f"{gate_s / m['wall_s']:.1%} of the wall, "
            f"{gate_s / m['batches'] * 1e3:.3f} ms a micro-batch in the "
            f"server against {ref_ms:.3f} ms in the synchronous reference "
            f"(no threads, one mask read each); admitted {m['admitted']} of "
            f"{m['decided']}; guard[{r.report.health_line}]")
    log(f"  (c) parity queued == synchronous on all three runs; card == CPU "
        f"on masks and the final state blob; the served path's launches "
        f"{card.payload['launches']} (4096), {big.payload['launches']} "
        f"(65536)")


# ===================================================================== 6
N_SHARDS = 4                   # S shards x 2^22 rows: a [3, 4 x 2^22] batch
SHARD_CASES = (("per_shard", "eager"), ("per_batch", "eager"),
               ("centralized", "eager"), ("centralized", "deferred"),
               ("centralized", "deferred-async"))
SHARD_FAULTS = dict(poison=(1,), storm=(2,), kill=(3,))


def _sharded_plan(**kw):
    from repro_torch.configs.paper_filters import PaperWorkload, filter_chain
    from repro_torch.core import FilterPlan

    kw.setdefault("shards", N_SHARDS)
    return FilterPlan(filter_chain("cnf"), PaperWorkload().ordering, **kw)


def phase_sharded(torch, dev, runs, kernels: list, smi: str) -> None:
    """Phase 6: sharding on the card (see the module docstring)."""
    s = N_SHARDS
    log(f"== phase 6: sharding ({s} shards x {BATCH_ROWS} rows a step, "
        "paper CNF chain, on one card)")
    t0 = time.perf_counter()
    # round-robin partitions of phase 3's stream: step k holds global
    # batches s·k .. s·k+s-1, shard i's as rows [i·R, (i+1)·R)
    batches = [torch.cat(runs["batches"][k * s:(k + 1) * s], dim=1)
               for k in range(N_BATCHES // s)]
    launches = {}
    launches["scopes"] = _sharded_scopes(torch, batches, smi)
    launches["pipeline"] = _sharded_pipeline(torch, runs, smi)
    launches["soak"] = _sharded_soak(torch, batches, smi)
    mask_only = launches["scopes"]["chain"]
    compact = launches["pipeline"]["chain"] + launches["soak"]["chain"]
    gather = launches["pipeline"]["gather"] + launches["soak"]["gather"]
    for row in kernels:
        got = {"filter_chain": mask_only, "filter_chain[compact]": compact,
               "compact_gather": gather}.get(row["name"])
        if got is not None:
            row["launches_sharded"] = got
    log(f"  phase 6 launches {launches}")
    log(f"  phase 6 took {time.perf_counter() - t0:.1f} s ({smi})")


def _sharded_scopes(torch, batches, smi: str) -> dict:
    """(a) Every scope and exchange mode on both engines: cuda == torch,
    per_shard == four unsharded sessions on the slices, one perm on every
    shard under centralized; rows/s and syncs per steady step."""
    from repro_torch.core import build_session
    from repro_torch.kernels.filter_chain import filter_chain as fc

    s, r, n = N_SHARDS, BATCH_ROWS, len(batches)
    total = {"chain": 0, "gather": 0}
    recs = {}
    for scope, exchange in SHARD_CASES:
        rec = {}
        for engine in ("cuda", "torch"):
            plan = _sharded_plan(engine=engine, scope=scope,
                                 exchange=exchange)
            fc.reset_launch_counts()
            session = build_session(plan)
            state, steps, syncs, _ = _drive(torch, session, batches,
                                            record=True, count_syncs=True)
            got = _launch_counts()
            _, _, _, seconds = _drive(torch, build_session(plan), batches,
                                      record=False, count_syncs=False)
            rec[engine] = dict(state=state, steps=steps, syncs=syncs,
                               arrays=session.save_state(state)["arrays"])
            if engine == "cuda":
                total["chain"] += got["chain"]
                check(got["chain"] == s * n and got["gather"] == 0,
                      f"{scope}/{exchange}: launches {got}, want chain "
                      f"{s * n} (one a shard a step)")
            else:
                check(not any(got.values()),
                      f"torch engine launched kernels {got}")
            check(state.perm.device.type == "cuda"
                  and steps[-1]["mask"].device.type == "cuda",
                  f"{scope}/{exchange}: state or mask left the card")
            log(f"  (a) {scope}/{exchange} engine={engine}: "
                f"{n * s * r / seconds:,.0f} rows/s ({seconds * 1e3:.1f} ms "
                f"for {n} steps of {s} x {r} rows; {smi}); syncs per "
                f"steady step {syncs}; launches {got}; final epochs "
                f"{state.epoch.tolist()}, perms {state.perm.tolist()}")
            # PERF.md §2: a sharded step reads nothing, a deferred boundary
            # included (it fires from the host mirror)
            check(max(syncs) == 0, f"{scope}/{exchange} engine={engine}: "
                  f"{max(syncs)} syncs in a steady step, budget 0")
        _same_run(torch, rec["cuda"], rec["torch"],
                  f"{scope}/{exchange}: cuda vs torch")
        check(int(rec["cuda"]["state"].epoch.min()) >= n,
              f"{scope}/{exchange}: epochs did not fire")
        if scope == "centralized":
            for i, st in enumerate(rec["cuda"]["steps"]):
                check(bool((st["perm"] == st["perm"][0]).all()),
                      f"centralized/{exchange}: shards' perms differ, "
                      f"step {i}")
        recs[(scope, exchange)] = rec
    log(f"  (a) cuda == torch on masks, perm trajectories and save_state "
        f"arrays in all {len(SHARD_CASES)} cases; centralized: one perm on "
        f"every shard at every step")

    per = recs[("per_shard", "eager")]["cuda"]
    for i in range(s):
        session = build_session(_sharded_plan(engine="cuda", shards=1))
        st = session.init_state()
        for k, cols in enumerate(batches):
            st, res = session.step(st, cols[:, i * r:(i + 1) * r])
            check(torch.equal(res.mask, per["steps"][k]["mask"][
                i * r:(i + 1) * r])
                  and torch.equal(st.perm, per["steps"][k]["perm"][i]),
                  f"per_shard: shard {i} differs from an unsharded "
                  f"session on its slice, step {k}")
        for key, v in session.save_state(st)["arrays"].items():
            check((per["arrays"][key][i] == v).all(),
                  f"per_shard: shard {i}'s {key} differs")
    log(f"  (a) per_shard == {s} unsharded cuda sessions on the slices "
        "(masks, perms, save_state arrays)")

    # the profile of a steady sharded step: the strided slices' copies
    session = build_session(_sharded_plan(engine="cuda",
                                          scope="centralized"))
    holder = [session.init_state()]
    for cols in batches[:2]:
        holder[0], _ = session.step(holder[0], cols)

    def step():
        holder[0], _ = session.step(holder[0], batches[2])

    ev, events = _profiled(torch, step, 4, ops=True)
    dev_us = sum(e.self_device_time_total for e in ev) / 4
    n_k = sum(e.count for e in ev) / 4
    chain = [e for e in ev if "chain_kernel" in e.key]
    chain_us = sum(e.self_device_time_total for e in chain) / 4
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:6]
    # the wrapper's .contiguous() of each shard's strided [C, R] slice
    # (ops._pad_cols), read off the step's own trace: the contiguous ops
    # on a [C, R] input that copied (one on a contiguous input launches
    # nothing) and the kernels they launched
    c = int(batches[2].shape[0])
    pads = [e for e in events if e.name == "aten::contiguous"
            and e.cpu_children and e.input_shapes
            and list(e.input_shapes[0]) == [c, r]]
    check(len(pads) == 4 * s, f"profile: {len(pads)} strided-slice "
          f"copies in 4 steps, expected {4 * s}")
    pad_k = [k for e in pads for k in _kernels_under(e)]
    pad_us = sum(k.duration for k in pad_k) / 4
    pad_names = sorted({k.name[:60] for k in pad_k})
    # every kernel of the step with "copy" in its name, for comparison
    copies = [e for e in ev if "copy" in e.key.lower()]
    # the same copy alone, by CUDA events (no other kernel around it)
    slices = [(batches[2][:, i * r:(i + 1) * r],) for i in range(s)]
    copy_ms = _device_ms(torch, lambda x: x.contiguous(), slices, 40)
    wall = _step_seconds(torch, step, 8)
    log(f"  (a) profile of a steady centralized/eager step on cuda ({smi}): "
        f"{dev_us:.1f} us of device time in {n_k:.0f} kernels, "
        f"{wall * 1e3:.2f} ms a step on the host clock "
        f"({dev_us / 1e6 / wall:.1%} busy); chain_kernel {chain_us:.1f} us "
        f"in {sum(e.count for e in chain) / 4:.0f} launches; the strided-"
        f"slice copies in the step's trace {pad_us:.1f} us in "
        f"{len(pad_k) / 4:.0f} kernels a step "
        f"({pad_us / max(dev_us, 1e-9):.1%} of its device time; "
        f"{pad_names}); every kernel named *copy* "
        f"{sum(e.self_device_time_total for e in copies) / 4:.1f} us in "
        f"{sum(e.count for e in copies) / 4:.0f} a step; one such copy "
        f"alone {copy_ms:.4f} ms by CUDA events; top kernels (us a step, "
        f"count): "
        + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 4:.1f} "
                    f"x{e.count / 4:.0f}" for e in top))
    return total


def _step_seconds(torch, step, n: int) -> float:
    """Median host-clock seconds of ``n`` synchronized calls of ``step``."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sorted(times)[n // 2]


def _resharded(arrays: dict, new_shards: int) -> dict:
    """What ``reshard_state_arrays`` gives a partitioned source whose
    shards agree on every derived array (centralized) for a partitioned
    target: each sum over the shards split evenly, the largest row
    counter, and the rest as it was."""
    import numpy as np

    out = {}
    for k, v in arrays.items():
        if k == "rows_into_epoch":
            piece = v.max()
        elif k.startswith("stats."):
            piece = (v.astype(np.float64).sum(axis=0) / new_shards) \
                .astype(v.dtype)
        else:
            check(bool((v == v[0]).all()), f"the source's {k} differs "
                  "between shards")
            piece = v[0]
        out[k] = np.broadcast_to(np.asarray(piece)[None],
                                 (new_shards,) + np.shape(piece))
    return out


def _same_arrays(got: dict, want: dict, what: str) -> None:
    for k, v in want.items():
        check(got[k].dtype == v.dtype and got[k].shape == v.shape
              and (got[k] == v).all(), f"{what}: {k} differs")


def _sharded_pipeline(torch, runs, smi: str) -> dict:
    """(b) The trainer's sharded input stage through ``make_pipeline``:
    cuda == torch on every LM batch, then restarts 4→4, 4→2 and 2→4."""
    import numpy as np

    from repro_torch.configs.paper_filters import PaperWorkload
    from repro_torch.core import TokenizeSpec, build_session
    from repro_torch.data import make_pipeline
    from repro_torch.data import stream as stream_lib
    from repro_torch.kernels.filter_chain import filter_chain as fc

    s, r = N_SHARDS, BATCH_ROWS
    n = N_BATCHES // s
    wl = PaperWorkload()
    spec = TokenizeSpec(INGEST_VOCAB, 8)
    per_batch = INGEST_LM["batch_size"] * (INGEST_LM["seq_len"] + 1)

    def plan(engine, shards=s):
        return _sharded_plan(engine=engine, shards=shards,
                             scope="centralized", exchange="deferred",
                             compact=True, capacity="auto", tokenize=spec)

    def pipeline(engine, shards=s):
        return make_pipeline(build_session(plan(engine, shards)),
                             total_rows=N_BATCHES * r,
                             batch_rows=r, seed=0, drift=wl.drift,
                             vocab_size=INGEST_VOCAB, **INGEST_LM)

    # the streams' batches are phase 3's (the same generator, seed and
    # drift): served from host memory, so the pipeline is timed, not numpy
    host = {b: c.cpu().numpy() for b, c in enumerate(runs["batches"])}
    generate = stream_lib.gen_batch

    def served(seed, b, start, rows, drift, layout="iid"):
        check(seed == 0 and rows == r and layout == "iid"
              and drift == wl.drift, "phase 6b asked for another stream")
        return host[b]

    stream_lib.gen_batch = served
    try:
        lm, st, at = [], None, 0
        fc.reset_launch_counts()
        pipe = pipeline("cuda")
        check(type(pipe).__name__ == "ShardedPipeline"
              and pipe._device_tokenize, "make_pipeline: not a sharded "
              "device-tokenize pipeline")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st_s = 0.0
        for b in pipe:
            lm.append(b)
            if st is None and pipe.streams[-1].cursor == 3 * s:
                t1 = time.perf_counter()
                st, at = pipe.state(), len(lm)
                st_s = time.perf_counter() - t1
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0 - st_s
        got = _launch_counts()
        check(got["chain"] == s * n and got["gather"] == s * n,
              f"sharded pipeline launches {got}, want {s * n} each")
        check(pipe.rows_in == n * s * r and len(lm) > 0,
              f"the pipeline took {pipe.rows_in} rows, emitted {len(lm)}")
        ref = pipeline("torch")
        i = -1
        for i, b in enumerate(ref):
            check(i < len(lm), "the torch pipeline emitted more batches")
            _same_lm_batch(b, lm[i], f"sharded pipeline cuda vs torch, LM "
                           f"batch {i}")
        check(i + 1 == len(lm), f"torch emitted {i + 1}, cuda {len(lm)}")
        n_tok = len(lm) * per_batch
        log(f"  (b) sharded pipeline (centralized, deferred, capacity=auto, "
            f"TokenizeSpec({INGEST_VOCAB}, 8)), {n} steps of {s} x {r} "
            f"rows: cuda == torch on all {len(lm)} LM batches "
            f"({pipe.rows_pass} of {pipe.rows_in} rows kept); "
            f"{n * s * r / seconds:,.0f} rows/s, {n_tok / seconds:,.0f} "
            f"tokens/s on the host clock ({seconds:.2f} s, stream served "
            f"from host memory; {smi}); launches {got}; last metrics "
            f"n_dropped_per_shard {pipe.last_metrics['n_dropped_per_shard']}")

        # where a step's host time goes: the shard batches' concatenation,
        # the pageable upload, the session step with the tokens' copy back
        parts = [host[b] for b in range(s)]
        cat_s = _step_seconds(torch, lambda: np.concatenate(parts, axis=1), 3)
        cat = np.concatenate(parts, axis=1)
        up_s = _step_seconds(torch, lambda: torch.as_tensor(cat, device="cuda"),
                             3)
        cols = torch.as_tensor(cat, device="cuda")
        session = build_session(plan("cuda"))
        holder = [session.init_state()]

        def step():
            holder[0], res = session.step(holder[0], cols)
            res.host_tokens()

        step()
        step_s = _step_seconds(torch, step, 5)
        log(f"  (b) a pipeline step's parts ({smi}), host clock medians: "
            f"concatenating the {s} shard batches {cat_s * 1e3:.1f} ms, the "
            f"pageable upload of {cat.nbytes / 2**20:.0f} MiB "
            f"{up_s * 1e3:.1f} ms, session.step + host_tokens on the "
            f"uploaded batch {step_s * 1e3:.1f} ms; the whole step "
            f"{seconds / n * 1e3:.1f} ms")

        # 4 → 4: the next batches bit-identical
        n_next = st.buffer.size // per_batch + 2
        same = pipeline("cuda")
        same.restore(st)
        nxt = [b for _, b in zip(range(n_next), same)]
        check(len(nxt) == n_next and at + n_next <= len(lm),
              f"4->4 restart emitted {len(nxt)} of {n_next}")
        for j, b in enumerate(nxt):
            _same_lm_batch(b, lm[at + j], f"4->4 restart, LM batch {at + j}")
        check(same.streams[-1].cursor == n * s, "4->4 restart: no step 4")

        # 4 → 2: reshard rules, the buffer's batches, then a step
        two = pipeline("cuda", shards=2)
        two.restore(st)
        want = _resharded(st.filter_state["arrays"], 2)
        _same_arrays(two._session.save_state(two._fstate)["arrays"], want,
                     "4->2 restore")
        buffered = st.buffer.size // per_batch
        out2 = [b for _, b in zip(range(buffered + 1), two)]
        for j in range(buffered):
            _same_lm_batch(out2[j], lm[at + j], f"4->2 restart, buffered LM "
                           f"batch {j}")
        check(two.streams[-1].cursor == 3 * s + 2
              and len(out2) == buffered + 1, "4->2 restart: no step")
        st2 = two.state()

        # 2 → 4: reshard rules, then a step
        four = pipeline("cuda")
        four.restore(st2)
        _same_arrays(four._session.save_state(four._fstate)["arrays"],
                     _resharded(st2.filter_state["arrays"], 4),
                     "2->4 restore")
        check([c.cursor for c in four.streams] == [3 * s + 2] * s,
              "2->4 restore: stream cursors")
        nb, out4 = len(out2), 0
        for _ in four:
            out4 += 1
            if four.rows_in > st2.rows_in:
                break
        check(four.rows_in == st2.rows_in + s * r, "2->4 restart: no step")
        log(f"  (b) restarts from the state after 3 steps: 4->4 gives the "
            f"next {n_next} LM batches bit-identically, into step 4; 4->2 "
            f"and 2->4 give reshard_state_arrays' arrays (sums split over "
            f"the new shards, the largest row counter, one perm) and run a "
            f"step ({nb} and {out4} LM batches up to its first)")
    finally:
        stream_lib.gen_batch = generate
    return got


def _sharded_soak(torch, batches, smi: str) -> dict:
    """(c) A guarded 4-shard soak: per_shard, a bounded capacity, one
    poisoned batch, one storm, one killed step; clean batches equal the
    fault-free run."""
    from repro_torch.core import build_session
    from repro_torch.data.stream import RequestStream
    from repro_torch.kernels.filter_chain import filter_chain as fc
    from repro_torch.runtime import (DataFaultInjector, FailureInjector,
                                     GuardedSession, GuardPolicy)

    s, r, n, f = N_SHARDS, BATCH_ROWS, len(batches), SHARD_FAULTS
    plan = _sharded_plan(engine="cuda", scope="per_shard", compact=True,
                         capacity=GUARD_CAPACITY)
    base = _masks(torch, plan, batches)
    host = [b.cpu().numpy() for b in batches]
    survivor = int(torch.nonzero(base[0])[0])
    inj = DataFaultInjector(poison_at=f["poison"], storm_at=f["storm"],
                            storm_row=host[0][:, survivor])
    kill = FailureInjector(f["kill"])
    guard = GuardedSession(build_session(plan),
                           GuardPolicy(validate_every=1, checkpoint_every=2),
                           step_injector=kill.maybe_fail)
    stream = RequestStream(lambda b, start, rows: host[b],
                           total_rows=n * s * r, batch_rows=s * r)
    fc.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, results = guard.run_log_stream(stream, batch_hook=inj)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = _launch_counts()
    check(sorted(results) == list(range(n)), f"soak results {sorted(results)}")
    for b, res in results.items():
        if b in f["poison"]:
            check(res.quarantined and not bool(res.mask.any())
                  and res.n_kept.shape == (s,) and res.n_pass == 0,
                  f"sharded soak: poisoned batch {b} not quarantined per "
                  "shard")
        elif b in f["storm"]:
            check(not res.quarantined and res.n_pass == s * r,
                  f"sharded soak: the storm kept {res.n_pass} of {s * r}")
        else:
            check(not res.quarantined and torch.equal(res.mask, base[b]),
                  f"sharded soak: clean batch {b} differs from the "
                  "unguarded run")
    h = guard.health
    check(h.quarantined == 1 and h.overflow_events == 1 and h.retries >= 1,
          f"sharded soak health {h.summary()}")
    check([e["changes"] for e in h.degrades] == [{"capacity": "None"}],
          f"sharded soak degrades {h.degrades}")
    check(guard.session.sharded and guard.session.num_shards == s
          and guard.session.validate_state(state)
          and tuple(state.perm.shape) == (s, 4),
          "sharded soak: final session or state")
    # every stepped batch launches once a shard, the storm's lossless
    # re-run once more; the poisoned batch and the killed step never
    launches = s * (n - len(f["poison"]) + len(f["storm"]))
    check(got["chain"] == launches and got["gather"] == launches,
          f"sharded soak launches {got}, expected {launches} each")
    log(f"  (c) guarded {s}-shard soak, {n} host batches of {s} x {r} rows, "
        f"per_shard, capacity {GUARD_CAPACITY} a shard, faults {f}: "
        f"{seconds:.2f} s ({smi}); clean batches == unguarded run, the "
        f"storm kept all {s * r} rows, the poisoned batch quarantined with "
        f"per-shard zeros; guard[{h.summary()}]; degrades "
        f"{[e['changes'] for e in h.degrades]}; launches {got}")
    return got


# ===================================================================== 7
FIG1_ROWS = 1_500_000          # benchmarks/common.py: BENCH_ROWS
FIG1_BATCH = 65536             # benchmarks/common.py: BATCH_ROWS
FIG1_INITS = ((0, 1, 2, 3), (3, 2, 1, 0), (3, 0, 2, 1))
FIG1_DRIFTS = ("none", "regime")   # benchmarks/run.py runs both
N_HOST_BATCHES = 4             # phase 7(b): phase 3's first 4 batches


def phase_host_paths(torch, dev, runs, kernels: list, smi: str) -> None:
    """Phase 7: the paper's experiments on the card (see the module
    docstring)."""
    log("== phase 7: the paper's host reference path (Figure 1's sweep on "
        "cuda and numpy; process_stream at full width)")
    t0 = time.perf_counter()
    launches = {"fig1": _fig1_sweep(torch, smi),
                "full": _host_full_width(torch, runs, smi)}
    for row in kernels:
        got = {"filter_chain": launches["fig1"]["chain"],
               "filter_chain[compact]": launches["full"]["chain"],
               "compact_gather": launches["full"]["gather"]
               }.get(row["name"])
        if got is not None:
            row["launches_host_paths"] = got
    log(f"  phase 7 launches {launches}")
    log(f"  phase 7 took {time.perf_counter() - t0:.1f} s ({smi})")


def _fig1_filters(engine: str, drift_kind: str, cost_mode: str = "static",
                  statics: bool = True):
    """Figure 1's runs as ``benchmarks/fig1_permutations.py`` builds them:
    (name, filter) for the 24 static orders of the paper's chain, then
    adaptive runs from three initial orders."""
    import itertools

    from repro_torch.core import (AdaptiveFilter, AdaptiveFilterConfig,
                                  OrderingConfig, paper_filters_4,
                                  static_filter)

    preds = paper_filters_4("fig1")
    ordering = OrderingConfig(collect_rate=1000, calculate_rate=200_000,
                              momentum=0.3)
    if statics:
        for perm in itertools.permutations(range(4)):
            yield f"static_{''.join(map(str, perm))}", static_filter(
                preds, order=list(perm), backend=engine)
    for init in FIG1_INITS:
        yield f"adaptive_{''.join(map(str, init))}", AdaptiveFilter(
            [preds[i] for i in init], AdaptiveFilterConfig(
                ordering=ordering, backend=engine, cost_mode=cost_mode))


def _fig1_run(filt, batches) -> tuple[list, float]:
    """One run of the figure: per batch (mask, metrics), wall seconds."""
    t0 = time.perf_counter()
    out = [(mask, d) for _, mask, d in filt.process_stream(batches)]
    return out, time.perf_counter() - t0


def _fig1_summary(label: str, works: dict, seconds: float, rows: int,
                  smi: str) -> None:
    statics = [w for k, w in works.items() if k.startswith("static")]
    adaptive = [w for k, w in works.items() if k.startswith("adaptive")]
    best, worst = min(statics), max(statics)
    log(f"    {label}: static spread {worst / best:.3f}x (paper: ~2.3x), "
        f"adaptive/best {max(adaptive) / best:.3f}, adaptive/worst "
        f"{max(adaptive) / worst:.3f}; {len(works)} runs in {seconds:.2f} s,"
        f" {seconds * 1e6 / (len(works) * rows):.4f} us/row ({smi})")


def _fig1_sweep(torch, smi: str) -> dict:
    """(a) Figure 1's sweep on ``cuda`` and on ``numpy``, both with static
    costs: every batch's mask, perm, epoch and n_pass equal, work units
    within rel 1e-5, one chain launch a batch on ``cuda``; then the
    adaptive runs on ``numpy`` with measured costs, as the figure runs
    them."""
    import numpy as np

    from repro_torch.data.stream import DriftConfig, gen_batch
    from repro_torch.kernels.filter_chain import filter_chain as fc

    n = max(1, FIG1_ROWS // FIG1_BATCH)
    rows = n * FIG1_BATCH
    fc.reset_launch_counts()
    n_cuda_runs = 0
    for kind in FIG1_DRIFTS:
        drift = DriftConfig(kind=kind, period_rows=750_000, amplitude=1.5)
        batches = [gen_batch(0, b, b * FIG1_BATCH, FIG1_BATCH, drift)
                   for b in range(n)]
        log(f"  (a) Figure 1, drift {kind}: {n} batches of {FIG1_BATCH} "
            f"rows ({rows:,} rows), 24 static orders + adaptive from "
            f"{len(FIG1_INITS)} initial orders")
        works = {"cuda": {}, "numpy": {}}
        seconds = {"cuda": 0.0, "numpy": 0.0}
        for (name, f_cu), (_, f_np) in zip(_fig1_filters("cuda", kind),
                                           _fig1_filters("numpy", kind)):
            got, s_cu = _fig1_run(f_cu, batches)
            want, s_np = _fig1_run(f_np, batches)
            n_cuda_runs += 1
            seconds["cuda"] += s_cu
            seconds["numpy"] += s_np
            check(len(got) == len(want) == n, f"fig1 {kind} {name}: "
                  f"{len(got)} / {len(want)} batches")
            keys = ("perm", "epoch", "n_pass")
            for i, ((gm, gd), (wm, wd)) in enumerate(zip(got, want)):
                g, w = ({k: d[k] for k in keys} for d in (gd, wd))
                check(np.array_equal(gm, wm) and g == w,
                      f"fig1 {kind} {name}, batch {i}: cuda != numpy "
                      f"(mask equal {np.array_equal(gm, wm)}; {g} vs {w})")
                check(abs(gd["work_units"] - wd["work_units"])
                      <= 1e-5 * abs(wd["work_units"]),
                      f"fig1 {kind} {name}, batch {i}: work units "
                      f"{gd['work_units']} vs {wd['work_units']}")
            for eng, out in (("cuda", got), ("numpy", want)):
                works[eng][name] = sum(d["work_units"] for _, d in out)
            if name.startswith("adaptive"):
                log(f"    {name}: final perm {got[-1][1]['perm']}, epochs "
                    f"{got[-1][1]['epoch']}")
        for eng in ("cuda", "numpy"):
            _fig1_summary(eng, works[eng], seconds[eng], rows, smi)
        measured = []
        t0 = time.perf_counter()
        for name, filt in _fig1_filters("numpy", kind, "measured",
                                        statics=False):
            out, sec = _fig1_run(filt, batches)
            check(all(sorted(d["perm"]) == [0, 1, 2, 3] for _, d in out),
                  f"fig1 {kind} {name} measured: a perm is no permutation")
            measured.append(f"{name} perm {out[-1][1]['perm']} "
                            f"{sec * 1e6 / rows:.4f} us/row")
        log(f"    numpy, cost_mode=measured ({time.perf_counter() - t0:.2f}"
            f" s): " + "; ".join(measured))
    got = _launch_counts()
    want = dict(chain=n_cuda_runs * n, skip=0, gather=0, stats=0)
    check(got == want, f"fig1 launches {got}, expected {want}")
    log(f"  (a) cuda == numpy on every batch of {n_cuda_runs} runs "
        f"(masks, perm, epoch, n_pass; work units within rel 1e-5); "
        f"launches {got}")
    return got


def _host_full_width(torch, runs, smi: str) -> dict:
    """(b) Phase 3's first batches through ``process_stream`` of the
    paper's surface: ``cuda`` with ``compact_output=True,
    compact_capacity="auto"`` (the survivors out of the gather kernel)
    and ``numpy``; the survivors must be equal."""
    import numpy as np

    from repro_torch.configs.paper_filters import PaperWorkload, filter_chain
    from repro_torch.core import AdaptiveFilter, AdaptiveFilterConfig
    from repro_torch.kernels.filter_chain import filter_chain as fc

    n, r = N_HOST_BATCHES, BATCH_ROWS
    batches = runs["batches"][:n]
    host = [b.cpu().numpy() for b in batches]
    preds, ordering = filter_chain("cnf"), PaperWorkload().ordering
    cu = AdaptiveFilter(preds, AdaptiveFilterConfig(
        ordering=ordering, backend="cuda", compact_output=True,
        compact_capacity="auto"), device=batches[0].device)
    fc.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = list(cu.process_stream(batches))
    s_cu = time.perf_counter() - t0
    launched = _launch_counts()
    t0 = time.perf_counter()
    want = list(AdaptiveFilter(preds, AdaptiveFilterConfig(
        ordering=ordering, backend="numpy")).process_stream(host))
    s_np = time.perf_counter() - t0
    check(launched == dict(chain=n, skip=0, gather=n, stats=0),
          f"full-width process_stream launches {launched}")
    for i, ((gs, gm, gd), (ws, wm, wd)) in enumerate(zip(got, want)):
        check(np.array_equal(gs, ws) and gs.shape[1] == wd["n_pass"] > 0
              and np.array_equal(gm, wm) and gd["perm"] == wd["perm"]
              and gd["epoch"] == wd["epoch"] and gd["n_dropped"] == 0,
              f"full-width process_stream, batch {i}: cuda survivors "
              f"{gs.shape} != numpy {ws.shape} or perm/epoch differ")
    phase3 = N_BATCHES * r / runs["auto"]["cuda"]["seconds"]
    log(f"  (b) process_stream, {n} x {r} rows of phase 3, paper CNF chain: "
        f"cuda (compact_output, capacity auto) {n * r / s_cu:,.0f} rows/s "
        f"({s_cu * 1e3:.1f} ms), numpy {n * r / s_np:,.0f} rows/s "
        f"({s_np:.2f} s); survivors equal, "
        f"{sum(d['n_pass'] for *_, d in got):,} rows; phase 3's session.step on cuda with capacity auto "
        f"{phase3:,.0f} rows/s, compaction off "
        f"{N_BATCHES * r / runs['off']['cuda']['seconds']:,.0f} rows/s "
        f"({smi}); launches {launched}")
    return launched


if __name__ == "__main__":
    sys.exit(main())
