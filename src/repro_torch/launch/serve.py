"""Serving CLI of the port: the continuous-batching admission server, thin.

PyTorch port of ``repro.launch.serve`` (the ``--executor sim`` path; the
model-backed slots are ROADMAP.md queue 1 item 11). All mechanism lives in
``repro_torch.serving`` — this launcher only builds the pieces (drifting-
mix traffic → ``RequestStream``, guardrail plan → session on the card
unless ``--device cpu``, slot executor) and wires them into
``AdmissionServer``, then writes the metrics payload where ``--bench-out``
says (nowhere without it) and applies the gates:

  * PARITY (correctness, hard): the queued server's admit/reject
    sequence and final ``OrderState`` must be bit-identical to a
    synchronous reference run over the same seeded traffic — queuing
    changes latency, never admission decisions.
  * requests/sec and p99 admission latency (perf, ``--smoke`` only):
    conservative absolute floors that catch gross stalls (a blocked
    queue, a per-batch rebuild) without flaking on slow runners.

  PYTHONPATH=src python -m repro_torch.launch.serve --guarded
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke \\
      --bench-out /tmp/serve.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import NamedTuple

import numpy as np

from repro_torch.core import FilterPlan, OrderingConfig, build_session
from repro_torch.data.stream import RequestStream
from repro_torch.kernels.filter_chain import filter_chain as fc
from repro_torch.runtime import GracefulShutdown, GuardedSession, GuardPolicy
from repro_torch.serving import (AdmissionServer, ServerConfig, SimExecutor,
                                 TrafficConfig, TrafficGenerator,
                                 guardrail_chain, phase_of,
                                 synchronous_reference)

__all__ = ["guardrail_chain", "ServeRun", "run", "main"]


class ServeRun(NamedTuple):
    """What one CLI run produced: the exit code, the server's report
    (masks, final state blob, metrics) and the metrics payload."""

    rc: int
    report: object
    payload: dict


def _parity(report, ref_masks, ref_blob) -> dict:
    """Bit-compare the server run against the synchronous oracle."""
    masks_equal = set(report.masks) == set(ref_masks) and all(
        np.array_equal(report.masks[b], ref_masks[b]) for b in ref_masks)
    a, b = report.state_blob["arrays"], ref_blob["arrays"]
    state_equal = set(a) == set(b) and all(
        np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)
    return {"checked": True, "masks_equal": bool(masks_equal),
            "state_equal": bool(state_equal),
            "ok": bool(masks_equal and state_equal)}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="small 3-phase run + parity/perf gates")
    ap.add_argument("--requests", type=int, default=None,
                    help="total requests (default 4096; 1536 under --smoke)")
    ap.add_argument("--batch", type=int, default=64,
                    help="admission micro-batch rows")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--queue-depth", type=int, default=8)
    ap.add_argument("--max-backlog", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--users", type=int, default=1 << 20,
                    help="persistent synthetic user identities")
    ap.add_argument("--phase-requests", type=int, default=None,
                    help="rows per traffic phase (default requests//3: the "
                         "run sweeps organic → abuse storm → enterprise)")
    ap.add_argument("--guarded", action="store_true",
                    help="wrap the gate in the self-healing GuardedSession "
                         "(always on under --smoke so the payload carries "
                         "real GuardHealth counters)")
    ap.add_argument("--promote-after", type=int, default=4,
                    help="clean validated boundaries before a degraded "
                         "rung re-promotes (guarded runs)")
    ap.add_argument("--executor", choices=("sim", "model"), default="sim")
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="the gate's device (default cuda; pass cpu to run "
                         "on the CPU)")
    ap.add_argument("--bench-out", default=None,
                    help="write the metrics payload (JSON) here; nothing "
                         "is written without it")
    ap.add_argument("--state-out", default=os.path.join(
                        tempfile.gettempdir(), "repro_torch_serve_state.json"),
                    help="where a graceful SIGINT/SIGTERM flushes the "
                         "guardrail OrderState (versioned session blob)")
    ap.add_argument("--no-reference", action="store_true",
                    help="skip the synchronous parity reference run")
    ap.add_argument("--gate-rps", type=float, default=100.0,
                    help="smoke gate: minimum sustained requests/sec")
    ap.add_argument("--gate-p99-ms", type=float, default=2500.0,
                    help="smoke gate: maximum p99 admission latency")
    return ap


def run(argv: list[str] | None = None) -> ServeRun:
    """Parse ``argv``, serve, check the gates; see the module docstring."""
    args = _parser().parse_args(argv)
    if args.executor == "model":
        raise NotImplementedError(
            "--executor model needs the LM stack, which is not ported to "
            "repro_torch yet: ROADMAP.md queue 1 item 11 (ModelSlotExecutor)")

    requests = args.requests if args.requests is not None \
        else (1536 if args.smoke else 4096)
    requests = (requests // args.batch) * args.batch or args.batch
    phase_requests = args.phase_requests or max(requests // 3, args.batch)
    guarded = args.guarded or args.smoke

    tcfg = TrafficConfig(seed=args.seed, n_users=args.users,
                         phase_requests=phase_requests)
    traffic = TrafficGenerator(tcfg)
    n_batches = requests // args.batch
    phases_seen = sorted({phase_of(tcfg, b * args.batch + args.batch / 2)
                          for b in range(n_batches)})

    # the guardrail stage is ONE declarative plan: compile it to a session
    # and drive the single step entry point (the API the pipelines use)
    plan = FilterPlan(
        predicates=guardrail_chain(),
        ordering=OrderingConfig(collect_rate=4, calculate_rate=64,
                                momentum=0.3))
    session = build_session(plan, device=args.device)
    if guarded:
        session = GuardedSession(
            session, GuardPolicy(promote_after=args.promote_after))

    server = AdmissionServer(
        session,
        RequestStream(traffic.gen, total_rows=requests,
                      batch_rows=args.batch),
        ServerConfig(num_slots=args.slots, queue_depth=args.queue_depth,
                     max_backlog=args.max_backlog),
        executor=SimExecutor(max_decode_steps=args.new_tokens),
        warmup_batch=traffic.gen(0, 0, args.batch))

    stop = GracefulShutdown()
    before = fc.launch_counts()
    t0 = time.time()
    with stop:
        report = server.run(stop=stop)
    dt = time.time() - t0
    # the served path's own launches (its warmup included): the reference
    # below launches the same kernels again
    launches = {k: v - before[k] for k, v in fc.launch_counts().items()}

    if stop.requested:
        # graceful shutdown: the server drained in-flight slots and
        # flushed the final checkpoint into the report — persist it
        blob = report.state_blob
        payload = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                   for k, v in blob.items() if k != "arrays"}
        payload["arrays"] = {k: np.asarray(v).tolist()
                             for k, v in blob["arrays"].items()}
        payload["dtypes"] = {k: str(np.asarray(v).dtype)
                             for k, v in blob["arrays"].items()}
        with open(args.state_out, "w") as f:
            json.dump(payload, f)
        print(f"[serve] shutdown requested: drained {len(report.results)} "
              f"results; guardrail state flushed to {args.state_out}")
        print("[serve] resume: restores via FilterSession.restore_state")

    parity = {"checked": False, "ok": None}
    if not args.no_reference and not stop.requested:
        ref_session = build_session(plan, device=args.device)
        t_ref = time.perf_counter()
        ref_state, ref_masks = synchronous_reference(
            ref_session,
            RequestStream(traffic.gen, total_rows=requests,
                          batch_rows=args.batch))
        # the same gate steps with no queue, thread or slot beside them
        ref_s = time.perf_counter() - t_ref
        parity = _parity(report, ref_masks, ref_session.save_state(ref_state))
        parity["reference_s"] = ref_s

    m = report.metrics
    payload = {
        **m,
        "parity": parity,
        "launches": launches,
        "config": {
            "requests": requests, "batch": args.batch, "slots": args.slots,
            "queue_depth": args.queue_depth, "seed": args.seed,
            "n_users": args.users, "phase_requests": phase_requests,
            "phases_seen": phases_seen, "guarded": guarded,
            "executor": args.executor, "smoke": args.smoke,
            "device": str(session.device),
        },
    }
    if args.bench_out is not None:
        with open(args.bench_out, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)

    lat = m["admission_latency_ms"]
    health = f" guard[{report.health_line}]" if report.health_line else ""
    print(f"[serve] {m['decided']}/{m['requests']} decided on "
          f"{session.device} (admitted={m['admit_rate']:.2f} "
          f"rejected={m['reject_rate']:.2f} "
          f"quarantined={m['quarantine_rate']:.2f}) "
          f"{m['requests_per_sec']:.0f} req/s "
          f"p99 admission {lat['p99']:.1f}ms "
          f"occupancy {m['slot_occupancy']:.2f} "
          f"phases {phases_seen} ({dt:.1f}s){health}")
    if args.bench_out is not None:
        print(f"[serve] wrote {args.bench_out}")

    failures = []
    if parity["checked"] and not parity["ok"]:
        failures.append(f"PARITY: queued admission diverged from the "
                        f"synchronous reference ({parity})")
    if args.smoke and not stop.requested:
        if m["requests_per_sec"] < args.gate_rps:
            failures.append(f"requests/sec {m['requests_per_sec']:.0f} "
                            f"< floor {args.gate_rps:.0f}")
        if lat["p99"] > args.gate_p99_ms:
            failures.append(f"p99 admission {lat['p99']:.1f}ms "
                            f"> ceiling {args.gate_p99_ms:.0f}ms")
    for msg in failures:
        print(f"[serve] GATE FAILED: {msg}")
    return ServeRun(1 if failures else 0, report, payload)


def main(argv: list[str] | None = None) -> int:
    return run(argv).rc


if __name__ == "__main__":
    sys.exit(main())
