"""Cross-rank metric aggregation and persisted snapshot flight records.

Counterpart of ``torchsnapshot_tpu/obs/aggregate.py``, writing the same
``.snapshot_obsrecord`` format (each package reads the other's).  A
rank's payload carries its topology placement (``topology``: slice,
host, counts) when an explicit topology was detected, and the payload
transport's stamp (``transport``: the engine the last resolve chose and
this operation's collective, KV and fallback deltas) once one was
resolved, and the live continuous loop's summary (``continuous``:
replica residency and replication lag, ``continuous/loop.py``); the
merged record rolls the placements up per slice (``topology.slices``:
ranks, replicated write egress, fan-out durable reads and savings) and
the loops' summaries up to the fleet's floors (``continuous``), the rows
the CLI's ``doctor`` renders.

The single-process half of observability (metrics.py, tracer.py) dies
with the process and never crosses a rank boundary; this module is the
distributed, persistent half.  After a take/restore each rank computes
its per-operation **metrics delta** (counters/histograms windowed
against a capture taken at operation start) plus a phase rollup
(``phase.*`` histograms: stage/encode/write/read/consume/barrier
seconds) and publishes it over the coordination KV under explicit keys
(``{uid}/obsrec/{rank}`` — background-thread-legal, no collectives).
Rank 0 merges the payloads — counters summed, histograms bucket-summed,
gauges per-rank — computes **straggler attribution** (which rank, which
phase, per-backend breakdown), and persists the merged record next to
the snapshot as ``.snapshot_obsrecord``:

- written **before** the ``.snapshot_metadata`` commit marker and
  strictly best-effort — a lost record can never fail a commit;
- **self-CRC'd** like the metadata file (trailer comment carrying the
  body crc32), so a truncated/corrupt record is detected, not
  misrendered;
- publication is best-effort per rank: a rank failing between its data
  writes and its publish degrades the record to a partial one with the
  missing rank NOTED, never blocks the commit, and every wait for a
  payload has a deadline.

``python -m torchsnapshot_tpu doctor <path>`` renders a record
(slowest ranks/objects/phases, goodput) and diffs two of them
step-over-step.
"""

from __future__ import annotations

import json
import logging
import time
from typing import Any, Dict, List, Optional, Sequence

from . import goodput as goodput_mod
from . import tracer as tracer_mod
from .metrics import PHASE_PREFIX, metrics_snapshot
from ..utils.selfcrc import append_crc_trailer, strip_crc_trailer

logger = logging.getLogger(__name__)

OBSRECORD_FNAME = ".snapshot_obsrecord"
RECORD_VERSION = 1

# Self-checksum trailer, same construction as the metadata file's
# (manifest._META_CRC_MARKER): newline + '#' can never occur inside the
# JSON body (json.dumps escapes newlines), and a plain-JSON/YAML reader
# treats the trailer as trailing garbage/comment rather than data.
_RECORD_CRC_MARKER = "\n#tsnp-obsrecord-crc32:"

# How long rank 0 waits for one rank's payload AFTER the commit barrier
# already proved the rank finished its writes: the payload was published
# before the barrier, so anything still missing is a failed (best-effort)
# publish, not an in-flight one — keep the wait short.
_COLLECT_TIMEOUT_S = 5.0

# Slowest-object rollup: only available when tracing recorded the
# operation's pipeline spans; bounded so the record stays small.
_TOP_OBJECTS = 10
_OBJECT_SPAN_NAMES = ("pipeline/io", "pipeline/stream", "pipeline/staging")

# The last merged record of each operation kind, kept in-process so
# restores (which have no natural persistence point next to a snapshot
# they may lack write access to) are still inspectable.
_LAST_RECORDS: Dict[str, Dict[str, Any]] = {}


# --------------------------------------------------------- delta/merge


def capture() -> Dict[str, Any]:
    """Registry capture at operation start; pair with ``delta``."""
    return metrics_snapshot()


def delta(before: Dict[str, Any], after: Dict[str, Any]) -> Dict[str, Any]:
    """Windowed registry view of one operation: counters and histogram
    counts/sums subtract cleanly; gauges cannot be windowed (their
    value/high-water is as-of-capture) and are carried from ``after``
    verbatim.  Instruments born mid-window delta against zero."""
    b_counters = before.get("counters", {})
    counters = {
        name: v - b_counters.get(name, 0)
        for name, v in after.get("counters", {}).items()
        if v - b_counters.get(name, 0)
    }
    b_hists = before.get("histograms", {})
    histograms = {}
    for name, h in after.get("histograms", {}).items():
        bh = b_hists.get(name)
        if bh is not None and bh.get("bounds") == h.get("bounds"):
            d = {
                "count": h["count"] - bh["count"],
                "sum": h["sum"] - bh["sum"],
                # min/max are process-lifetime (not windowable)
                "min": h["min"],
                "max": h["max"],
                "bounds": h["bounds"],
                "counts": [
                    a - b for a, b in zip(h["counts"], bh["counts"])
                ],
            }
        else:
            d = dict(h)
        if d["count"]:
            histograms[name] = d
    return {
        "counters": counters,
        "gauges": dict(after.get("gauges", {})),
        "histograms": histograms,
    }


def _phase_rollup(metrics: Dict[str, Any]) -> Dict[str, Dict[str, float]]:
    """phase name → {seconds, count} from the ``phase.*`` histograms of
    one rank's delta."""
    out: Dict[str, Dict[str, float]] = {}
    for name, h in metrics.get("histograms", {}).items():
        if name.startswith(PHASE_PREFIX) and h.get("count"):
            phase = name[len(PHASE_PREFIX):]
            if phase.endswith("_s"):
                phase = phase[:-2]
            out[phase] = {
                "seconds": round(float(h.get("sum", 0.0)), 6),
                "count": int(h.get("count", 0)),
            }
    return out


def _backend_rollup(metrics: Dict[str, Any]) -> Dict[str, Dict[str, float]]:
    """backend → {write_s, read_s, write_bytes, read_bytes} from the
    per-backend storage instruments of one rank's delta."""
    out: Dict[str, Dict[str, float]] = {}
    for name, h in metrics.get("histograms", {}).items():
        if not name.startswith("storage.") or not name.endswith(
            "_latency_s"
        ):
            continue
        parts = name.split(".")
        if len(parts) != 3:
            continue  # storage.stripe.part_* / storage.codec.* rollups
        backend, op = parts[1], parts[2][: -len("_latency_s")]
        if h.get("count"):
            out.setdefault(backend, {})[f"{op}_s"] = round(
                float(h.get("sum", 0.0)), 6
            )
    for name, v in metrics.get("counters", {}).items():
        if name.startswith("storage.") and name.endswith(
            ("write_bytes", "read_bytes")
        ):
            parts = name.split(".")
            if len(parts) == 3 and v:
                out.setdefault(parts[1], {})[parts[2]] = v
    return out


def _slow_objects_from_tracer() -> List[Dict[str, Any]]:
    """Top-N slowest per-object pipeline spans (path + phase + seconds)
    when tracing recorded the operation; [] when tracing is off — the
    record notes object-level detail is span-gated."""
    if not tracer_mod.ENABLED:
        return []
    spans = [
        s
        for s in tracer_mod.get_tracer().spans()
        if s.name in _OBJECT_SPAN_NAMES and s.end_ns and "path" in s.attrs
    ]
    spans.sort(key=lambda s: s.duration_ns, reverse=True)
    return [
        {
            "path": str(s.attrs.get("path")),
            "phase": s.name.rsplit("/", 1)[-1],
            "seconds": round(s.duration_ns / 1e9, 6),
            "bytes": s.attrs.get("bytes"),
        }
        for s in spans[:_TOP_OBJECTS]
    ]


def _topology_stamp() -> Optional[Dict[str, Any]]:
    """This process's last-detected explicit placement, or None (never
    raises)."""
    try:
        from ..topology import current_topology_info

        return current_topology_info()
    except Exception as e:  # noqa: BLE001 — telemetry never fails the op
        from .. import obs

        obs.swallowed_exception("obs.aggregate.topology_stamp", e)
        return None


# counter → per-slice field of the record's topology rows
_TOPOLOGY_SLICE_COUNTERS = (
    ("topology.replicated_objects_written", "replicated_objects_written"),
    ("topology.replicated_bytes_written", "replicated_bytes_written"),
    ("topology.fanout_durable_reads", "durable_reads"),
    ("topology.durable_gets_saved", "durable_gets_saved"),
    ("topology.fanout_bytes_redistributed", "bytes_redistributed"),
    ("topology.fanout_fallbacks", "fanout_fallbacks"),
)


def _topology_rollup(payloads: Sequence[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """Per-slice rows (ranks, write egress, fan-out savings) from the
    payloads' placements and counter deltas; None when no rank stamped
    one."""
    stamped = [p for p in payloads if isinstance(p.get("topology"), dict)]
    if not stamped:
        return None
    slices: Dict[str, Dict[str, Any]] = {}
    for p in stamped:
        s = str(p["topology"].get("slice", 0))
        row = slices.setdefault(
            s, {"ranks": [], **{field: 0 for _, field in _TOPOLOGY_SLICE_COUNTERS}}
        )
        row["ranks"].append(int(p["rank"]))
        counters = (p.get("metrics") or {}).get("counters") or {}
        for name, field in _TOPOLOGY_SLICE_COUNTERS:
            row[field] += int(counters.get(name, 0))
    for row in slices.values():
        row["ranks"].sort()
    return {
        "num_slices": max(int(p["topology"].get("num_slices", 1)) for p in stamped),
        "slices": dict(sorted(slices.items(), key=lambda kv: int(kv[0]))),
    }


def _transport_stamp(metric_delta: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """The engine the last ``resolve_transport`` of this process chose and
    this operation's transport deltas, or None before any resolve (never
    raises).  A fleet that degraded to KV shows ``engine: kv`` or
    non-zero ``fallbacks`` on the affected ranks."""
    try:
        from ..transport import current_engine

        engine = current_engine()
        if engine is None:
            return None
        c = metric_delta.get("counters", {})
        return {
            "engine": engine,
            "collective_ops": int(c.get("transport.collective_ops", 0)),
            "collective_bytes": int(c.get("transport.collective_bytes", 0)),
            "kv_ops": int(c.get("transport.kv_ops", 0)),
            "kv_bytes": int(c.get("transport.kv_bytes", 0)),
            "fallbacks": int(c.get("transport.fallbacks", 0)),
            # the JAX record's key; nothing in the port moves payloads
            # through the device outside a transfer yet, so it stays 0
            "device_moves": int(c.get("transport.device_moves", 0)),
        }
    except Exception as e:  # noqa: BLE001 — telemetry never fails the op
        from .. import obs

        obs.swallowed_exception("obs.aggregate.transport_stamp", e)
        return None


def _continuous_stamp() -> Optional[Dict[str, Any]]:
    """The live continuous loop's ``summary_block()``, or None; never
    raises."""
    try:
        from ..continuous import summary_block

        return summary_block()
    except Exception as e:  # noqa: BLE001 — telemetry never fails the op
        from .. import obs

        obs.swallowed_exception("obs.aggregate.continuous_stamp", e)
        return None


def rank_payload(
    rank: int, op: str, before: Dict[str, Any]
) -> Dict[str, Any]:
    """One rank's flight-record contribution for the operation that
    started at the ``before`` capture.  NEVER raises: every call site
    sits on a commit path inside an abort scope, where a latent
    telemetry bug must cost record fidelity, not the checkpoint — a
    failed rollup degrades to a minimal payload noting the error."""
    try:
        m = delta(before, metrics_snapshot())
        out = {
            "rank": rank,
            "op": op,
            "metrics": m,
            "phases": _phase_rollup(m),
            "backends": _backend_rollup(m),
            "goodput": goodput_mod.block(),
            "slow_objects": _slow_objects_from_tracer(),
        }
        tinfo = _topology_stamp()
        if tinfo is not None:
            out["topology"] = tinfo
        cinfo = _continuous_stamp()
        if cinfo is not None:
            out["continuous"] = cinfo
        xinfo = _transport_stamp(m)
        if xinfo is not None:
            out["transport"] = xinfo
        return out
    except Exception as e:  # noqa: BLE001 — telemetry never fails the op
        from .. import obs

        obs.swallowed_exception("obs.aggregate.rank_payload", e)
        return {
            "rank": rank,
            "op": op,
            "metrics": {},
            "phases": {},
            "backends": {},
            "goodput": {},
            "slow_objects": [],
            "error": repr(e)[:200],
        }


def _merge_metrics(deltas: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    counters: Dict[str, int] = {}
    gauges: Dict[str, Dict[str, Any]] = {}
    histograms: Dict[str, Dict[str, Any]] = {}
    for d in deltas:
        for name, v in d.get("counters", {}).items():
            counters[name] = counters.get(name, 0) + v
        for name, g in d.get("gauges", {}).items():
            cur = gauges.setdefault(name, {"value": 0.0, "max": 0.0})
            cur["value"] = max(cur["value"], g.get("value", 0.0))
            cur["max"] = max(cur["max"], g.get("max", 0.0))
        for name, h in d.get("histograms", {}).items():
            cur = histograms.get(name)
            if cur is None:
                histograms[name] = {
                    k: (list(v) if isinstance(v, list) else v)
                    for k, v in h.items()
                }
                continue
            if cur.get("bounds") != h.get("bounds"):
                # bound skew across ranks (version mismatch): keep the
                # first rank's histogram rather than sum apples+oranges
                continue
            cur["count"] += h["count"]
            cur["sum"] += h["sum"]
            cur["counts"] = [
                a + b for a, b in zip(cur["counts"], h["counts"])
            ]
            for agg, fn in (("min", min), ("max", max)):
                vals = [v for v in (cur.get(agg), h.get(agg)) if v is not None]
                cur[agg] = fn(vals) if vals else None
    return {
        "counters": counters,
        "gauges": gauges,
        "histograms": histograms,
    }


def _straggler(
    phases_by_rank: Dict[str, Dict[str, Dict[str, float]]]
) -> Optional[Dict[str, Any]]:
    """The rank with the largest total WORK time, attributed to its
    dominant phase; None when no rank reported any work phase.

    Barrier seconds are excluded from the totals: barrier time is by
    definition time spent WAITING on other ranks — the fastest rank
    accrues the most of it while the real straggler works, so counting
    it would name the victim.  It stays visible in the per-rank table;
    it just never wins the attribution."""
    def work(phases):
        return {
            name: p for name, p in phases.items() if name != "barrier"
        }

    totals = {
        r: sum(p["seconds"] for p in work(phases).values())
        for r, phases in phases_by_rank.items()
        if work(phases)
    }
    if not totals:
        return None
    worst = max(totals, key=totals.get)
    phases = work(phases_by_rank[worst])
    phase = max(phases, key=lambda p: phases[p]["seconds"])
    others = [s for r, s in totals.items() if r != worst]
    return {
        "rank": int(worst),
        "phase": phase,
        "seconds": round(phases[phase]["seconds"], 6),
        "total_s": round(totals[worst], 6),
        "lead_over_peers_s": round(
            totals[worst] - (max(others) if others else 0.0), 6
        ),
    }


def merge_payloads(
    payloads: Sequence[Dict[str, Any]],
    op: str,
    path: str,
    world_size: int,
) -> Dict[str, Any]:
    """The merged flight record: summed counters, merged histograms,
    per-rank phase/backend rollups, straggler attribution, fleet
    goodput, and the slowest objects across all reporting ranks.
    ``payloads`` may be partial — absent ranks land in
    ``missing_ranks`` and every rollup is computed over what arrived."""
    payloads = [p for p in payloads if p]
    reported = sorted(int(p["rank"]) for p in payloads)
    phases_by_rank = {
        str(p["rank"]): p.get("phases", {}) for p in payloads
    }
    goodputs = {
        str(p["rank"]): p.get("goodput", {}) for p in payloads
    }
    slow = sorted(
        (o for p in payloads for o in p.get("slow_objects", ())),
        key=lambda o: o.get("seconds", 0.0),
        reverse=True,
    )[:_TOP_OBJECTS]
    merged_goodput: Dict[str, Any] = {"by_rank": goodputs}
    for key in (
        "time_to_unblock_s",
        "durability_lag_s",
        "overhead_fraction",
    ):
        vals = [
            g[key]
            for g in goodputs.values()
            if isinstance(g.get(key), (int, float))
        ]
        # the fleet unblocks when the SLOWEST rank does
        merged_goodput[key] = round(max(vals), 6) if vals else None
    record = {
        "record": "tsnp-obsrecord",
        "version": RECORD_VERSION,
        "op": op,
        "path": path,
        "world_size": world_size,
        "ranks_reported": reported,
        "missing_ranks": sorted(set(range(world_size)) - set(reported)),
        "merged": _merge_metrics([p.get("metrics", {}) for p in payloads]),
        "per_rank": {
            str(p["rank"]): {
                "phases": p.get("phases", {}),
                "backends": p.get("backends", {}),
            }
            for p in payloads
        },
        "straggler": _straggler(phases_by_rank),
        "goodput": merged_goodput,
        "slow_objects": slow,
    }
    topology = _topology_rollup(payloads)
    if topology is not None:
        record["topology"] = topology
    continuous = _continuous_rollup(payloads)
    if continuous is not None:
        record["continuous"] = continuous
    return record


def _continuous_rollup(payloads: Sequence[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """The fleet's continuous rows: each rank's residency and the weakest
    guarantees (the least last-peer and last-durable step over the ranks:
    a preemption may hit any host); None when no rank runs a loop."""
    stamped = [p for p in payloads if isinstance(p.get("continuous"), dict)]
    if not stamped:
        return None
    by_rank = {str(p["rank"]): p["continuous"] for p in stamped}

    def _floor(key: str) -> Optional[int]:
        vals = [c.get(key) for c in by_rank.values() if isinstance(c.get(key), int)]
        return min(vals) if vals else None

    lags = [
        c.get("replication_lag_steps")
        for c in by_rank.values()
        if isinstance(c.get("replication_lag_steps"), int)
    ]
    return {
        "by_rank": by_rank,
        "last_peer_step_floor": _floor("last_peer_step"),
        "last_durable_step_floor": _floor("last_durable_step"),
        "max_replication_lag_steps": max(lags) if lags else None,
    }


# ------------------------------------------------------ KV publication


def _obsrec_key(uid: str, rank: int) -> str:
    return f"{uid}/obsrec/{rank}"


def publish(coordinator: Any, uid: str, payload: Dict[str, Any]) -> bool:
    """Best-effort publication of this rank's payload under the
    operation uid.  Never raises: a failed publish (a dead KV, a payload
    that does not encode) degrades the merged record to a partial one —
    it must not fail a take whose data writes all landed."""
    from .. import obs

    with obs.span("obs/publish", rank=coordinator.rank, uid=uid):
        try:
            if coordinator.world_size == 1:
                _LAST_RECORDS[f"_local/{uid}"] = payload
            else:
                coordinator.kv_set(
                    _obsrec_key(uid, coordinator.rank),
                    json.dumps(payload),
                )
            return True
        except Exception as e:  # noqa: BLE001 — best-effort by contract
            obs.swallowed_exception("obs.aggregate.publish", e)
            return False


def collect_and_merge(
    coordinator: Any, uid: str, op: str, path: str
) -> Dict[str, Any]:
    """Rank 0's half of ``exchange``: gather whatever payloads were
    published under ``uid`` and merge them.  Called strictly AFTER the
    commit barrier proved every surviving rank finished (so a short
    per-rank wait suffices); ranks that never published are noted in
    the record, never waited on for long."""
    payloads: List[Dict[str, Any]] = []
    world = coordinator.world_size
    if world == 1:
        local = _LAST_RECORDS.pop(f"_local/{uid}", None)
        if local is not None:
            payloads.append(local)
    else:
        # ONE shared deadline for all ranks, not one per missing rank:
        # a systematic publish failure must cost at most one collect
        # window before the commit proceeds, never world_size windows
        # (which would outwait the commit barrier at fleet scale)
        raws: Dict[int, Optional[str]] = {
            r: coordinator.kv_try_get(_obsrec_key(uid, r))
            for r in range(world)
        }
        deadline = time.monotonic() + _COLLECT_TIMEOUT_S
        while any(v is None for v in raws.values()) and (
            time.monotonic() < deadline
        ):
            # bounded poll: KV propagation may trail the barrier on
            # real coordination services
            time.sleep(0.05)
            for r, v in raws.items():
                if v is None:
                    raws[r] = coordinator.kv_try_get(_obsrec_key(uid, r))
        for r in range(world):
            raw = raws[r]
            if raw is None:
                continue
            try:
                payloads.append(json.loads(raw))
            except (ValueError, TypeError) as e:
                from .. import obs

                obs.swallowed_exception("obs.aggregate.decode", e)
    record = merge_payloads(payloads, op=op, path=path, world_size=world)
    _LAST_RECORDS[op] = record
    return record


def exchange_and_merge(
    coordinator: Any,
    uid: str,
    payload: Dict[str, Any],
    op: str,
    path: str,
) -> Optional[Dict[str, Any]]:
    """Publish this rank's payload and, on rank 0, merge everything
    published so far (single-phase convenience for call sites that have
    already synchronized — restore's tail).  Returns the merged record
    on rank 0, None elsewhere."""
    from .. import obs

    with obs.span("obs/exchange_and_merge", uid=uid, op=op):
        publish(coordinator, uid, payload)
        if coordinator.rank != 0:
            return None
        try:
            return collect_and_merge(coordinator, uid, op=op, path=path)
        except Exception as e:  # noqa: BLE001 — telemetry never fails the op
            obs.swallowed_exception("obs.aggregate.exchange", e)
            return None


def last_record(op: str) -> Optional[Dict[str, Any]]:
    """The most recent merged record of kind ``op`` in this process
    (rank 0 only fills these)."""
    return _LAST_RECORDS.get(op)


# ------------------------------------------------------- persistence


def encode_record(record: Dict[str, Any]) -> bytes:
    """Serialize with the self-checksum trailer (same discipline — and
    same shared implementation, ``utils/selfcrc.py`` — as
    ``.snapshot_metadata``: the record explains incidents, so it must
    be able to vouch for its own bytes)."""
    return append_crc_trailer(
        json.dumps(record, sort_keys=True), _RECORD_CRC_MARKER
    ).encode()


def decode_record(data: bytes) -> Dict[str, Any]:
    """Parse + verify a ``.snapshot_obsrecord``; raises ``RuntimeError``
    on checksum mismatch, a mangled trailer, or structural garbage."""
    s = bytes(data).decode()
    s, _ = strip_crc_trailer(
        s, _RECORD_CRC_MARKER, "obsrecord", ".snapshot_obsrecord"
    )
    try:
        record = json.loads(s)
    except ValueError as e:
        raise RuntimeError(
            f".snapshot_obsrecord is not parseable: {e}"
        ) from e
    if not isinstance(record, dict) or record.get("record") != "tsnp-obsrecord":
        raise RuntimeError(
            ".snapshot_obsrecord has an unexpected structure "
            "(not a flight record)"
        )
    return record


def write_obsrecord(storage: Any, record: Dict[str, Any]) -> bool:
    """Best-effort persistence next to the snapshot, BEFORE the caller
    writes the metadata commit marker.  Never raises — a take whose
    data is durable must commit even when its trace record cannot be
    written."""
    from .. import obs
    from ..io_types import WriteIO

    with obs.span("obs/write_obsrecord", path=record.get("path")):
        try:
            storage.sync_write(
                WriteIO(path=OBSRECORD_FNAME, buf=encode_record(record))
            )
            return True
        except Exception as e:  # noqa: BLE001 — best-effort by contract
            obs.swallowed_exception("obs.aggregate.write_obsrecord", e)
            return False


def read_obsrecord(path: str) -> Dict[str, Any]:
    """Load + verify the flight record stored next to a snapshot."""
    from .. import obs
    from ..io_types import ReadIO
    from ..storage import url_to_storage_plugin

    with obs.span("obs/read_obsrecord", path=path):
        storage = url_to_storage_plugin(path)
        try:
            read_io = ReadIO(path=OBSRECORD_FNAME)
            storage.sync_read(read_io)
        except FileNotFoundError as e:
            raise FileNotFoundError(
                f"no {OBSRECORD_FNAME} under {path!r} — the snapshot was "
                f"taken before flight records existed, or the record's "
                f"best-effort write failed"
            ) from e
        finally:
            storage.sync_close()
        return decode_record(bytes(memoryview(read_io.buf).cast("B")))
