"""Operator CLI: inspect, audit and manage snapshots from a shell.

    python -m torchsnapshot_tpu_torch ls        <snapshot-path>
    python -m torchsnapshot_tpu_torch stats     <snapshot-path> [--json] [--top N]
    python -m torchsnapshot_tpu_torch doctor    <snapshot-path> [--json] [--diff OTHER]
    python -m torchsnapshot_tpu_torch manifest  <snapshot-path>
    python -m torchsnapshot_tpu_torch verify    <snapshot-path> [--deep] [--rank N]
    python -m torchsnapshot_tpu_torch steps     <manager-root>
    python -m torchsnapshot_tpu_torch tiers     <durable-root> --fast <fast-root> [--json]
    python -m torchsnapshot_tpu_torch cas       <cas-root> [--json] [--fsck] [--gc] [--grace S]
    python -m torchsnapshot_tpu_torch delete    <snapshot-path> --yes
    python -m torchsnapshot_tpu_torch trace     <snapshot-path> [--out FILE] [--device cpu]
    python -m torchsnapshot_tpu_torch convert   <src> <dest> [--to-reference] [--rank N] [--device cpu]
    python -m torchsnapshot_tpu_torch lint      [root] [--json] [--pass ID]

Counterpart of ``python -m torchsnapshot_tpu``: these commands print
what the JAX package's print, field for field, and exit with the same
codes (non-zero when a verify fails or a delete is refused).  ``trace``
and ``convert`` hold the leaves on the card unless ``--device cpu``, as
the port's entry points do; ``trace`` writes the torch profiler's
events beside the spans and, on the card, prints the device's idle
seconds by span after its line.  ``stats`` of a continuous root (one store,
or a host root of per-rank stores) prints its residency rollup, and of a
live-weight publication root its HEAD, last delta and subscribers' lag.
``lint`` runs the checkout's snaplint suite (``tools/lint``) with the
arguments that follow it, as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from typing import Optional

def _human(n: float) -> str:
    if n < 1024:
        return f"{int(n)}B"
    for unit in ("KB", "MB", "GB", "TB"):
        n /= 1024.0
        if n < 1024 or unit == "TB":
            return f"{n:.1f}{unit}"
    raise AssertionError("unreachable")


def _cmd_ls(args) -> int:
    from .manifest import is_container_entry
    from .serialization import serialized_size_bytes
    from .snapshot import Snapshot

    rows = []
    for lpath, e in sorted(Snapshot(args.path).get_manifest().items()):
        if is_container_entry(e):
            continue
        detail, nbytes = "", 0
        shape, dtype = getattr(e, "shape", None), getattr(e, "dtype", None)
        if shape is not None and dtype is not None:
            detail = f"{dtype}{list(shape)}"
            nbytes = serialized_size_bytes(shape, dtype)
        rows.append((lpath, e.type, detail, nbytes))
    width = max((len(r[0]) for r in rows), default=10)
    for lpath, kind, detail, nbytes in rows:
        size = _human(nbytes) if nbytes else ""
        print(f"{lpath:<{width}}  {kind:<12} {detail:<24} {size}")
    print(f"{len(rows)} entries")
    return 0


def _entry_stats(entry) -> dict:
    """Size, dtype and piece count of one non-container entry, from the
    manifest alone: recorded byte ranges first, else dtype times shape."""
    from .serialization import serialized_size_bytes

    def extent(byte_range) -> int:
        return byte_range[1] - byte_range[0] if byte_range else 0

    dtype = getattr(entry, "dtype", None)
    nbytes = pieces = 0
    for attr in ("shards", "chunks"):
        for piece in getattr(entry, attr, None) or ():
            pieces += 1
            nbytes += extent(piece.byte_range) or (
                serialized_size_bytes(piece.sizes, dtype) if dtype is not None else 0
            )
    shape = getattr(entry, "shape", None)
    if not pieces:
        nbytes = extent(getattr(entry, "byte_range", None))
        if not nbytes and shape is not None and dtype is not None:
            nbytes = serialized_size_bytes(shape, dtype)
    return {
        "kind": entry.type,
        "dtype": dtype,
        # [] is a shape (a 0-d array), distinct from no shape (None)
        "shape": list(shape) if shape is not None else None,
        "nbytes": nbytes,
        "pieces": pieces,
    }


def _codec_rollup(metadata) -> dict:
    """Objects, raw and stored bytes per codec from the codec tables; an
    object in the objects table without a codec table is stored raw."""
    from .codec import table_stored_size, validate_table

    codecs_tbl = metadata.codecs or {}
    by_codec: dict = {}

    def bucket(name):
        return by_codec.setdefault(name, {"objects": 0, "raw_bytes": 0, "stored_bytes": 0})

    for tbl in codecs_tbl.values():
        if not validate_table(tbl):
            continue
        b = bucket(tbl["codec"])
        b["objects"] += 1
        b["raw_bytes"] += int(tbl["raw_size"])
        b["stored_bytes"] += table_stored_size(tbl)
    for loc, rec in (metadata.objects or {}).items():
        if loc not in codecs_tbl and isinstance(rec, (list, tuple)) and len(rec) == 3:
            b = bucket("raw")
            b["objects"] += 1
            b["raw_bytes"] += int(rec[2])
            b["stored_bytes"] += int(rec[2])
    raw_total = sum(b["raw_bytes"] for b in by_codec.values())
    stored_total = sum(b["stored_bytes"] for b in by_codec.values())
    return {
        "by_codec": by_codec,
        "raw_bytes": raw_total,
        "stored_bytes": stored_total,
        "ratio": (raw_total / stored_total) if stored_total else None,
    }


def _cas_stats_rollup(snapshot) -> dict:
    """How much of a snapshot is chunk-referenced, and the pool's index
    rollup when it reads; ``{}`` for a snapshot without chunks."""
    from . import cas as cas_mod

    metadata = snapshot.metadata
    meta_cas = metadata.cas or {}
    if not meta_cas:
        return {}
    tables = cas_mod.chunk_tables_from_metadata(metadata)
    distinct = {k for t in tables.values() for k in t["keys"]}
    out = {
        "root": meta_cas.get("root"),
        "chunked_objects": len(tables),
        "chunked_bytes": sum(int(t["size"]) for t in tables.values()),
        "distinct_chunks": len(distinct),
        "distinct_chunk_bytes": sum(cas_mod.key_size(k) for k in distinct),
    }
    store = cas_mod.ChunkStore(cas_mod.resolve_root(snapshot.path, str(meta_cas.get("root"))))
    try:
        out["index"] = cas_mod.ChunkIndex.load(store).rollup()
    except Exception as e:  # noqa: BLE001 — the snapshot's own numbers stand
        out["index_error"] = f"{e!r}"[:200]
    finally:
        store.sync_close()
    return out


def _cache_stats_rollup() -> dict:
    """Shared-host object cache rollup (``storage/hostcache.py``): the
    cache directory's footprint on disk, and this process's hit, miss and
    mapped-read counters (with the cache on, the command's own manifest
    read routes through it)."""
    from . import knobs, obs

    out: dict = {}
    cache_dir = knobs.get_cache_dir()
    if cache_dir:
        from .storage.hostcache import _OBJECTS_SUBDIR

        files = total = 0
        for dirpath, _dirs, names in os.walk(os.path.join(cache_dir, _OBJECTS_SUBDIR)):
            for name in names:
                try:
                    total += os.path.getsize(os.path.join(dirpath, name))
                    files += 1
                except OSError:
                    pass  # evicted by another process meanwhile
        out.update({"dir": cache_dir, "objects": files, "bytes": total})
    c = obs.counters()
    for key, short in (
        (obs.CACHE_HITS, "hits"),
        (obs.CACHE_MISSES, "misses"),
        (obs.CACHE_SINGLEFLIGHT_WAITS, "singleflight_waits"),
        (obs.MMAP_READS, "mmap_reads"),
    ):
        if c.get(key):
            out[short] = c[key]
    return out


def _render_cache_stats(rollup: dict) -> None:
    if "dir" in rollup:
        print(
            f"  cache: {rollup['objects']} objects, "
            f"{_human(rollup['bytes'])} at {rollup['dir']}"
        )
    if rollup.get("hits") or rollup.get("misses"):
        print(
            f"    this run: {rollup.get('hits', 0)} hits / "
            f"{rollup.get('misses', 0)} misses, "
            f"{rollup.get('singleflight_waits', 0)} singleflight waits, "
            f"{rollup.get('mmap_reads', 0)} mmap reads"
        )


def _render_cas_stats(rollup: dict) -> None:
    if not rollup:
        return
    print(
        f"  cas: {rollup['chunked_objects']} chunked objects, "
        f"{_human(rollup['chunked_bytes'])} logical -> "
        f"{rollup['distinct_chunks']} chunks, "
        f"{_human(rollup['distinct_chunk_bytes'])} distinct "
        f"(pool: {rollup.get('root')})"
    )
    idx = rollup.get("index")
    if not idx:
        if rollup.get("index_error"):
            print(f"    index unreadable: {rollup['index_error']}")
        return
    print(
        f"    pool: {idx['live_chunks']} live ({_human(idx['live_bytes'])}), "
        f"{idx['orphaned_chunks']} orphaned ({_human(idx['orphaned_bytes'])})"
    )
    hist = ", ".join(
        f"{n} ref{'s' if n != '1' else ''}: {c}" for n, c in idx["refcount_histogram"].items()
    )
    if hist:
        print(f"    refcounts: {hist}")
    for step, st in idx["per_step"].items():
        print(f"    {step}: {_human(st['new_bytes'])} new + {_human(st['shared_bytes'])} shared")


def _topology_stats_rollup(path: str) -> dict:
    """The topology rollup of the snapshot's flight record, ``{}`` when
    the record is absent, corrupt or has none."""
    from .obs import aggregate

    try:
        return aggregate.read_obsrecord(path).get("topology") or {}
    except (FileNotFoundError, RuntimeError):
        return {}


def _render_topology_rollup(topo, counters=None) -> None:
    """Multislice rows of a record's topology rollup (written when the
    operation ran on an explicit topology); silent for a single-slice
    record with no replicated write or fan-out to show."""
    c = counters or {}
    if not topo:
        return
    rows = (topo.get("slices") or {}).items()
    active = topo.get("num_slices", 1) > 1 or any(
        st.get("replicated_objects_written") or st.get("durable_gets_saved")
        or st.get("fanout_fallbacks")
        for _, st in rows
    )
    if not active:
        return
    print(f"  topology: {topo.get('num_slices', 1)} slice(s)")
    for sl, st in rows:
        parts = [f"ranks {st.get('ranks', [])}"]
        if st.get("replicated_objects_written"):
            parts.append(
                f"{st['replicated_objects_written']} replicated objects written "
                f"({_human(st.get('replicated_bytes_written', 0))})"
            )
        if st.get("durable_reads") or st.get("durable_gets_saved"):
            parts.append(
                f"{st.get('durable_reads', 0)} durable GETs, "
                f"{st.get('durable_gets_saved', 0)} saved "
                f"({_human(st.get('bytes_redistributed', 0))} redistributed)"
            )
        if st.get("fanout_fallbacks"):
            parts.append(f"{st['fanout_fallbacks']} fan-out fallbacks")
        print(f"    slice {sl}: " + ", ".join(parts))
    if c.get("fanout_fallbacks"):
        print(
            "    note: fallbacks mean siblings re-read directly (dead/slow "
            "designated reader or digest mismatch) — degraded, not wedged"
        )


def _publish_stats(path: str) -> Optional[dict]:
    """The rollup of a live-weight publication root (``publish/``): the
    published HEAD, the last update's delta cost and each subscriber's
    lag from its stamp; None when ``path`` is not one.  A local path is
    ruled out by the tag of its ``.snapshot_metadata`` (a snapshot's can
    be large), a remote one by reading it, as the JAX CLI does."""
    if "://" not in path or path.startswith("file://"):
        try:
            with open(os.path.join(path.split("://", 1)[-1], ".snapshot_metadata"), "rb") as f:
                if b'"tsnp-publication-head"' not in f.read(4096):
                    return None
        except OSError:
            return None
    from .publish import root_rollup

    return root_rollup(path)


def _render_publish_stats(roll: dict) -> None:
    print(f"{roll['root']}  [publication root]")
    line = f"  published step {roll['step']}"
    if roll.get("source"):
        line += f" (source: {roll['source']}, {roll.get('leaves', 0)} leaves)"
    print(line)
    if roll.get("record_error"):
        print(f"  WARNING: record unreadable: {roll['record_error']}")
    stats = roll.get("stats") or {}
    if stats.get("bytes_total"):
        ratio = stats.get("bytes_delta", 0) / stats["bytes_total"]
        print(
            f"  last update: {_human(stats.get('bytes_delta', 0))} delta "
            f"of {_human(stats['bytes_total'])} total "
            f"({ratio:.1%}; {stats.get('chunks_delta', 0)}/"
            f"{stats.get('chunks_total', 0)} chunks)"
        )
    subs = roll.get("subscribers") or []
    if not subs:
        print("  subscribers: (no stamps)")
        return
    print(f"  subscribers: {len(subs)}")
    for s in subs:
        if s.get("malformed"):
            print(f"    {s['id']}: MALFORMED stamp")
            continue
        print(
            f"    {s['id']}: step {s['step']} "
            f"(lag {s['lag_steps']} steps, stamped {s['age_s']:.1f}s "
            f"ago, gen {s['generation']}, "
            f"{_human(s['bytes_fetched'])} fetched)"
        )


def _continuous_store_rollup(root: str) -> Optional[dict]:
    """One continuous store's residency rollup, or None when ``root`` is
    not one (no decodable continuous HEAD).  Local roots only: probing a
    remote stats target would add a metadata GET to every cloud
    snapshot's stats."""
    from .cas.store import key_size
    from .continuous import ContinuousStore

    if "://" in root and not root.startswith("file://"):
        return None
    # every continuous store has steps/, a snapshot never: no read of a
    # snapshot's metadata just to rule the store out
    base = root.split("://", 1)[-1]
    if not os.path.isdir(os.path.join(base, "steps")):
        return None
    store = ContinuousStore(root)
    try:
        try:
            head = store.read_head()
        except Exception:  # noqa: BLE001 — not a continuous store: snapshot stats instead
            return None
        if head is None:
            return None
        out: dict = {"root": root, "head_step": int(head["step"])}
        try:
            manifest = store.read_step_manifest(str(head["manifest"]))
            keys = {k for rec in manifest["leaves"].values() for k in rec["keys"]}
            out["leaves"] = len(manifest["leaves"])
            out["head_chunks"] = len(keys)
            out["head_bytes"] = sum(key_size(k) for k in keys)
            out["chunk_size"] = int(manifest["chunk_size"])
        except Exception as e:  # noqa: BLE001 — a store torn mid-prune: report the HEAD
            out["manifest_error"] = f"{e!r}"[:200]
        out["steps_resident"] = sorted(
            int(n.split(".")[0])
            for n in os.listdir(os.path.join(base, "steps"))
            if n.endswith(".json") and n.split(".")[0].isdigit()
        )
        pool_bytes = pool_chunks = 0
        for dirpath, _dirs, files in os.walk(os.path.join(base, "objects")):
            for f in files:
                try:
                    pool_bytes += os.path.getsize(os.path.join(dirpath, f))
                    pool_chunks += 1
                except OSError:
                    pass  # racing the live loop's pruning
        out["pool_chunks"] = pool_chunks
        out["pool_bytes"] = pool_bytes
        return out
    finally:
        store.sync_close()


def _continuous_stats(path: str) -> Optional[dict]:
    """The rollup of a continuous root: one store, or a host root of
    ``r<k>`` stores; None when ``path`` is neither."""
    one = _continuous_store_rollup(path)
    if one is not None:
        return {"path": path, "stores": {"": one}}
    if "://" in path and not path.startswith("file://"):
        return None
    base = path.split("://", 1)[-1]
    if not os.path.isdir(base):
        return None
    stores = {}
    for name in sorted(os.listdir(base)):
        if re.fullmatch(r"r\d+", name):
            roll = _continuous_store_rollup(os.path.join(base, name))
            if roll is not None:
                stores[name] = roll
    if not stores:
        return None
    return {"path": path, "stores": stores}


def _render_continuous_stats(stats: dict) -> None:
    print(f"{stats['path']}  [continuous store]")
    for name, st in stats["stores"].items():
        line = f"  {name or '.'}: head step {st.get('head_step')}"
        if "head_chunks" in st:
            line += (
                f", {st['leaves']} leaves, {st['head_chunks']} chunks "
                f"({_human(st['head_bytes'])}) at "
                f"{_human(st.get('chunk_size', 0))} granularity"
            )
        print(line)
        if "steps_resident" in st:
            print(
                f"    steps resident: {st['steps_resident']}, pool "
                f"{st.get('pool_chunks', 0)} chunks "
                f"({_human(st.get('pool_bytes', 0))})"
            )
        if st.get("manifest_error"):
            print(f"    WARNING: manifest unreadable: {st['manifest_error']}")


def _cmd_stats(args) -> int:
    """Per-entry size, dtype and piece rollups from the manifest, with
    the codec and chunk-pool sections (no payload reads)."""
    from .manifest import is_container_entry
    from .snapshot import Snapshot

    pubroll = _publish_stats(args.path)
    if pubroll is not None:
        if args.json:
            print(json.dumps(pubroll, indent=2))
        else:
            _render_publish_stats(pubroll)
        return 0
    cont = _continuous_stats(args.path)
    if cont is not None:
        if args.json:
            print(json.dumps(cont, indent=2))
        else:
            _render_continuous_stats(cont)
        return 0
    snap = Snapshot(args.path)
    metadata = snap.metadata
    entries = {
        p: _entry_stats(e) for p, e in metadata.manifest.items() if not is_container_entry(e)
    }
    by_dtype: dict = {}
    by_kind: dict = {}
    total = pieces = 0
    for st in entries.values():
        total += st["nbytes"]
        pieces += st["pieces"]
        for table, key in ((by_dtype, st["dtype"] or "(none)"), (by_kind, st["kind"])):
            b = table.setdefault(key, {"count": 0, "bytes": 0})
            b["count"] += 1
            b["bytes"] += st["nbytes"]
    largest = sorted(entries.items(), key=lambda kv: kv[1]["nbytes"], reverse=True)[: args.top]
    stats = {
        "path": args.path,
        "world_size": metadata.world_size,
        "entries": len(entries),
        "total_bytes": total,
        "pieces": pieces,
        "by_kind": by_kind,
        "by_dtype": by_dtype,
        "largest": [{"path": p, **st} for p, st in largest],
        "codec": _codec_rollup(metadata),
        "cas": _cas_stats_rollup(snap),
        "cache": _cache_stats_rollup(),
        "topology": _topology_stats_rollup(args.path),
        "degraded": {
            p: d.get("origin_rank") for p, d in sorted((metadata.degraded or {}).items())
        },
    }
    if args.json:
        print(json.dumps(stats, indent=2))
        return 0
    print(f"{args.path}")
    print(
        f"  {len(entries)} entries, {pieces} shard/chunk pieces, "
        f"{_human(total)} total, world_size={metadata.world_size}"
    )
    for label, table in (("by kind", by_kind), ("by dtype", by_dtype)):
        print(f"  {label}:")
        for name, st in sorted(table.items(), key=lambda kv: -kv[1]["bytes"]):
            print(f"    {name:<14} {st['count']:>6}  {_human(st['bytes'])}")
    rollup = stats["codec"]
    if rollup["by_codec"]:
        ratio = rollup["ratio"]
        print(
            f"  codec: {_human(rollup['raw_bytes'])} raw -> "
            f"{_human(rollup['stored_bytes'])} stored"
            + (f" ({ratio:.2f}x)" if ratio else "")
        )
        for name, st in sorted(rollup["by_codec"].items(), key=lambda kv: -kv[1]["raw_bytes"]):
            r = st["raw_bytes"] / st["stored_bytes"] if st["stored_bytes"] else 0.0
            print(
                f"    {name:<14} {st['objects']:>6}  {_human(st['raw_bytes'])} -> "
                f"{_human(st['stored_bytes'])} ({r:.2f}x)"
            )
    _render_cas_stats(stats["cas"])
    _render_cache_stats(stats["cache"])
    _render_topology_rollup(stats["topology"])
    if stats["degraded"]:
        print(
            f"  DEGRADED: {len(stats['degraded'])} path(s) lost to rank death "
            "(re-take or `SnapshotManager.repair()` to heal):"
        )
        for p, origin in stats["degraded"].items():
            print(f"    {p}  (origin rank {origin})")
    print(f"  largest {len(largest)}:")
    width = max((len(p) for p, _ in largest), default=10)
    for p, st in largest:
        detail = f"{st['dtype']}{st['shape']}" if st["dtype"] else st["kind"]
        pieces_s = f" x{st['pieces']}" if st["pieces"] > 1 else ""
        print(f"    {p:<{width}}  {detail:<28} {_human(st['nbytes'])}{pieces_s}")
    return 0


def _doctor_phase_rows(record) -> list:
    """(rank, phases, seconds) of a record's per-rank rollups, slowest
    rank first."""
    rows = []
    for rank, pr in sorted((record.get("per_rank") or {}).items(), key=lambda kv: int(kv[0])):
        phases = pr.get("phases") or {}
        rows.append((int(rank), phases, sum(p.get("seconds", 0.0) for p in phases.values())))
    rows.sort(key=lambda r: -r[2])
    return rows


# doctor's headline counters: (key, counter name), 0 when absent
_DOCTOR_COUNTERS = (
    ("bytes_staged", "bytes_staged"),
    ("bytes_written", "bytes_written"),
    ("bytes_read", "bytes_read"),
    ("retries", "resilience.retries"),
)
_DOCTOR_COUNTERS_2 = (
    ("breaker_trips", "resilience.breaker_trips"),
    ("aborts", "resilience.aborts"),
    ("failpoints_fired", "resilience.failpoints_fired"),
    ("stripe_parts_written", "storage.stripe.parts_written"),
    ("stripe_aborts", "storage.stripe.aborts"),
    ("cache_hits", "storage.cache.hits"),
    ("cache_misses", "storage.cache.misses"),
    ("cache_singleflight_waits", "storage.cache.singleflight_waits"),
    ("mmap_reads", "storage.mmap.reads"),
    ("fanout_durable_reads", "topology.fanout_durable_reads"),
    ("fanout_gets_saved", "topology.durable_gets_saved"),
    ("fanout_bytes_redistributed", "topology.fanout_bytes_redistributed"),
    ("fanout_fallbacks", "topology.fanout_fallbacks"),
)
_DOCTOR_COUNTERS_3 = (
    ("continuous_steps", "continuous.steps"),
    ("continuous_bytes_replicated", "continuous.bytes_replicated"),
    ("continuous_bytes_skipped", "continuous.bytes_skipped"),
    ("continuous_replication_errors", "continuous.replication_errors"),
    ("continuous_preemption_drains", "continuous.preemption_drains"),
    ("publish_records", "publish.records"),
    ("publish_bytes_delta", "publish.bytes_delta"),
    ("publish_sub_swaps", "publish.subscriber_swaps"),
    ("publish_sub_bytes_fetched", "publish.subscriber_bytes_fetched"),
    ("publish_fallback_polls", "publish.fallback_polls"),
    ("publish_watch_errors", "publish.watch_errors"),
    ("publish_announce_failures", "publish.announce_failures"),
    ("exceptions_swallowed", "exceptions.swallowed"),
    ("liveness_heartbeats", "liveness.heartbeats"),
    ("dead_ranks_observed", "liveness.dead_ranks"),
    ("takeover_objects", "takeover.objects"),
    ("takeover_bytes", "takeover.bytes"),
    ("degraded_commits", "takeover.degraded_commits"),
    ("takeover_paths_repaired", "takeover.paths_repaired"),
    ("promoter_dead_peers", "takeover.promoter_dead_peers"),
)


def _doctor_counters(record) -> dict:
    """The counters an incident review starts from, in the JAX CLI's
    order and names."""
    c = (record.get("merged") or {}).get("counters") or {}
    cas_written = c.get("cas.bytes_written", 0)
    cas_shared = c.get("cas.bytes_shared", 0)
    codec_in = c.get("storage.codec.bytes_in", 0)
    codec_out = c.get("storage.codec.bytes_out", 0)
    out = {
        "cas_bytes_written": cas_written,
        "cas_bytes_shared": cas_shared,
        "cas_dedup_ratio": (
            round((cas_written + cas_shared) / cas_written, 3) if cas_written else None
        ),
    }
    out.update((k, c.get(name, 0)) for k, name in _DOCTOR_COUNTERS)
    grabbed = {k[len("resilience."):]: v for k, v in c.items() if k.startswith("resilience.")}
    out["retries_by_backend"] = {
        k.split(".")[0]: v for k, v in grabbed.items() if k.endswith(".retries")
    }
    out.update((k, c.get(name, 0)) for k, name in _DOCTOR_COUNTERS_2)
    out["codec_bytes_in"] = codec_in
    out["codec_bytes_out"] = codec_out
    out["codec_ratio"] = round(codec_in / codec_out, 3) if codec_out else None
    out.update((k, c.get(name, 0)) for k, name in _DOCTOR_COUNTERS_3)
    return out


def _render_continuous_rollup(cont, counters=None) -> None:
    """Replica residency rows of a record's continuous rollup; silent for
    a record without a continuous loop (every record the port writes)."""
    c = counters or {}
    if not cont:
        return
    floor_peer = cont.get("last_peer_step_floor")
    floor_dur = cont.get("last_durable_step_floor")
    lag = cont.get("max_replication_lag_steps")
    print(
        "  continuous: peer-step floor "
        f"{floor_peer if floor_peer is not None else '-'}, "
        f"durable-step floor {floor_dur if floor_dur is not None else '-'}"
        + (f", max replication lag {lag} step(s)" if lag is not None else "")
    )
    for rank, row in sorted((cont.get("by_rank") or {}).items(), key=lambda kv: int(kv[0])):
        print(
            f"    rank {rank}: step {row.get('last_step')}"
            f" | peers hold {row.get('last_peer_step')}"
            f" ({row.get('peer_targets', 0)} target(s))"
            f" | durable {row.get('last_durable_step')}"
        )
    if c.get("continuous_bytes_replicated") or c.get("continuous_bytes_skipped"):
        rep = c.get("continuous_bytes_replicated", 0)
        skip = c.get("continuous_bytes_skipped", 0)
        total = rep + skip
        print(
            f"    delta economics: {_human(rep)} replicated, {_human(skip)} skipped"
            + (f" ({skip / total:.0%} unchanged)" if total else "")
        )
    if c.get("continuous_replication_errors"):
        print(
            f"    WARNING: {c['continuous_replication_errors']} replication error(s) "
            "— affected targets held their previous step (degraded, not torn)"
        )


def _render_doctor(record) -> None:
    print(f"{record.get('path')}  [{record.get('op')}]  world_size={record.get('world_size')}")
    missing = record.get("missing_ranks") or []
    print(
        f"  ranks reported: {record.get('ranks_reported')}"
        + (f"  MISSING: {missing}" if missing else "")
    )
    gp = record.get("goodput") or {}
    parts = []
    for label, key in (
        ("unblock", "time_to_unblock_s"),
        ("durable-lag", "durability_lag_s"),
        ("overhead", "overhead_fraction"),
    ):
        v = gp.get(key)
        if v is not None:
            parts.append(f"{label} {v:.3f}s" if "fraction" not in key else f"{label} {v:.1%}")
    if parts:
        print("  goodput: " + ", ".join(parts))
    straggler = record.get("straggler")
    if straggler:
        print(
            f"  straggler: rank {straggler['rank']} ({straggler['phase']} phase, "
            f"{straggler['seconds']:.3f}s; "
            f"+{straggler.get('lead_over_peers_s', 0.0):.3f}s over peers)"
        )
    rows = _doctor_phase_rows(record)
    if rows:
        phases = sorted({p for _, ph, _ in rows for p in ph})
        hdr = "  ".join(f"{p:>10}" for p in phases)
        print(f"  {'rank':>6}  {hdr}  {'total':>10}")
        for rank, ph, total in rows:
            cells = "  ".join(f"{ph.get(p, {}).get('seconds', 0.0):>10.3f}" for p in phases)
            print(f"  {rank:>6}  {cells}  {total:>10.3f}")
    c = _doctor_counters(record)
    print(
        f"  io: {_human(c['bytes_staged'])} staged, {_human(c['bytes_written'])} "
        f"written, {_human(c['bytes_read'])} read"
    )
    health = (
        f"  health: {c['retries']} retries, {c['breaker_trips']} breaker trips, "
        f"{c['aborts']} aborts, {c['exceptions_swallowed']} swallowed"
    )
    if c["retries_by_backend"]:
        health += f" (by backend: {c['retries_by_backend']})"
    print(health)
    if c["stripe_parts_written"] or c["stripe_aborts"]:
        print(f"  stripe: {c['stripe_parts_written']} parts written, {c['stripe_aborts']} aborts")
    if c["codec_ratio"]:
        print(
            f"  codec: {_human(c['codec_bytes_in'])} raw -> "
            f"{_human(c['codec_bytes_out'])} stored ({c['codec_ratio']:.2f}x)"
        )
    if c["cas_bytes_written"] or c["cas_bytes_shared"]:
        ratio = c["cas_dedup_ratio"]
        print(
            f"  cas: {_human(c['cas_bytes_written'])} new + "
            f"{_human(c['cas_bytes_shared'])} shared"
            + (f" ({ratio:.2f}x dedup)" if ratio else "")
        )
    if c["cache_hits"] or c["cache_misses"]:
        served = c["cache_hits"] + c["cache_misses"]
        print(
            f"  cache: {c['cache_hits']} hits / {c['cache_misses']} misses "
            f"({c['cache_hits'] / served if served else 0.0:.0%} hit rate), "
            f"{c['cache_singleflight_waits']} singleflight waits"
        )
    if c["mmap_reads"]:
        print(f"  mmap: {c['mmap_reads']} zero-copy reads")
    if (
        c["dead_ranks_observed"] or c["takeover_objects"] or c["degraded_commits"]
        or c["promoter_dead_peers"] or c["takeover_paths_repaired"]
    ):
        print(
            f"  liveness: {c['dead_ranks_observed']} rank death(s) observed "
            f"({c['liveness_heartbeats']} heartbeats)"
        )
        parts = []
        if c["takeover_objects"]:
            parts.append(
                f"{c['takeover_objects']} objects re-written by survivors "
                f"({_human(c['takeover_bytes'])})"
            )
        if c["degraded_commits"]:
            parts.append(f"{c['degraded_commits']} degraded commit(s)")
        if c["promoter_dead_peers"]:
            parts.append(f"{c['promoter_dead_peers']} dead peer(s) skipped during tier promotion")
        if c["takeover_paths_repaired"]:
            parts.append(f"{c['takeover_paths_repaired']} path(s) repaired")
        if parts:
            print("  takeover: " + ", ".join(parts))
    if c["publish_records"] or c["publish_sub_swaps"]:
        line = (
            f"  publish: {c['publish_records']} records "
            f"({_human(c['publish_bytes_delta'])} delta), "
            f"{c['publish_sub_swaps']} subscriber swaps "
            f"({_human(c['publish_sub_bytes_fetched'])} fetched)"
        )
        trouble = [
            f"{c[k]} {label}"
            for k, label in (
                ("publish_fallback_polls", "fallback polls"),
                ("publish_announce_failures", "announce failures"),
                ("publish_watch_errors", "watch errors"),
            )
            if c[k]
        ]
        if trouble:
            line += " — " + ", ".join(trouble)
        print(line)
    _render_topology_rollup(record.get("topology"), c)
    _render_continuous_rollup(record.get("continuous"), c)
    slow = record.get("slow_objects") or []
    if slow:
        print("  slowest objects:")
        for o in slow[:5]:
            size = f" {_human(o['bytes'])}" if o.get("bytes") else ""
            print(f"    {o['path']}  [{o['phase']}]  {o['seconds']:.3f}s{size}")
    else:
        print(
            "  slowest objects: (none recorded — run the take under "
            "TORCHSNAPSHOT_TPU_TRACE=1 for object-level attribution)"
        )


def _doctor_diff(a, b) -> dict:
    """Per-phase and headline-counter deltas of two records (b minus a)."""

    def phase_totals(rec):
        out: dict = {}
        for _, ph, _ in _doctor_phase_rows(rec):
            for p, v in ph.items():
                out[p] = out.get(p, 0.0) + v.get("seconds", 0.0)
        return out

    pa, pb = phase_totals(a), phase_totals(b)
    ca, cb = _doctor_counters(a), _doctor_counters(b)
    numeric = [
        k for k in ca
        if isinstance(ca.get(k), (int, float)) and isinstance(cb.get(k), (int, float))
    ]
    return {
        "a": {"path": a.get("path"), "op": a.get("op")},
        "b": {"path": b.get("path"), "op": b.get("op")},
        "phases": {
            p: {
                "a_s": round(pa.get(p, 0.0), 6),
                "b_s": round(pb.get(p, 0.0), 6),
                "delta_s": round(pb.get(p, 0.0) - pa.get(p, 0.0), 6),
            }
            for p in sorted(set(pa) | set(pb))
        },
        "counters": {k: {"a": ca[k], "b": cb[k], "delta": cb[k] - ca[k]} for k in numeric},
        "straggler": {"a": a.get("straggler"), "b": b.get("straggler")},
        "goodput": {"a": a.get("goodput"), "b": b.get("goodput")},
    }


def _cmd_doctor(args) -> int:
    """Render a snapshot's flight record (``.snapshot_obsrecord``): the
    straggler rank and phase, per-rank phase seconds, the retry, breaker,
    codec and chunk-store counters; ``--diff`` compares two records."""
    from .obs import aggregate

    record = aggregate.read_obsrecord(args.path)
    if args.diff:
        diff = _doctor_diff(record, aggregate.read_obsrecord(args.diff))
        if args.json:
            print(json.dumps(diff, indent=2))
            return 0
        print(f"diff: {args.path} -> {args.diff}")
        print(f"  {'phase':>10}  {'a':>10}  {'b':>10}  {'delta':>10}")
        for p, d in diff["phases"].items():
            print(f"  {p:>10}  {d['a_s']:>10.3f}  {d['b_s']:>10.3f}  {d['delta_s']:>+10.3f}")
        for k, d in diff["counters"].items():
            if d["delta"]:
                print(f"  {k}: {d['a']} -> {d['b']} ({d['delta']:+})")
        return 0
    if args.json:
        print(json.dumps(record, indent=2))
        return 0
    _render_doctor(record)
    return 0


def _cmd_trace(args) -> int:
    """Materialize every entry with span tracing on, under the torch
    profiler (with CUDA activity when the leaves land on the card), and
    write one Chrome trace_event JSON with the spans on the profiler's
    clock beside its events (open it at ui.perfetto.dev).  On the card,
    print the device's idle seconds by innermost span."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from . import knobs, obs
    from .snapshot import Snapshot

    out = args.out or "trace.json"
    on_card = torch.device(args.device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with knobs.override_trace(1):
        obs.get_tracer().reset()
        with profile(activities=activities) as prof:
            Snapshot(args.path).materialize(rank=args.rank, device=args.device)
            if on_card:
                torch.cuda.synchronize()
        prof.export_chrome_trace(out)
        spans = obs.get_tracer().spans()
        idle = obs.merge_into(out, spans)
    print(f"wrote {sum(1 for s in spans if s.end_ns)} spans to {out}")
    if on_card:
        print("device idle seconds by span:")
        for name, seconds in idle.items():
            print(f"  {seconds:12.6f}  {name}")
    return 0


def _cmd_cas(args) -> int:
    """Operate on a chunk pool: its index rollup (default), ``--fsck`` (a
    rebuild from the committed manifests), ``--gc`` (mark and sweep).
    ``root`` is the pool root itself (``<manager-root>/cas``)."""
    from . import cas as cas_mod

    out: dict = {"root": args.root}
    if args.fsck:
        out["fsck"] = cas_mod.fsck(args.root)
    if args.gc:
        out["gc"] = cas_mod.run_gc(args.root, grace_s=args.grace)
    store = cas_mod.ChunkStore(args.root)
    try:
        out["index"] = cas_mod.ChunkIndex.load(store).rollup()
    except cas_mod.ChunkIndexCorruptError as e:
        out["index_error"] = str(e)
    finally:
        store.sync_close()
    if args.json:
        print(json.dumps(out, indent=2))
        return 0 if "index_error" not in out else 1
    if "index_error" in out:
        print(f"error: {out['index_error']} (run with --fsck to rebuild)", file=sys.stderr)
        return 1
    idx = out["index"]
    print(f"{args.root}")
    if out.get("fsck"):
        f = out["fsck"]
        print(
            f"  fsck: {f['snapshots_committed']} committed snapshots, {f['chunks']} "
            f"chunks, {f['orphans_marked']} orphans marked"
            + (f", {len(f['missing_chunks'])} MISSING" if f["missing_chunks"] else "")
        )
    if out.get("gc"):
        g = out["gc"]
        print(
            f"  gc: {g['marked']} marked, {g['swept_chunks']} swept "
            f"({_human(g['swept_bytes'])})"
        )
    print(
        f"  {idx['live_chunks']} live chunks ({_human(idx['live_bytes'])}), "
        f"{idx['orphaned_chunks']} orphaned ({_human(idx['orphaned_bytes'])})"
    )
    hist = ", ".join(f"{n}: {cnt}" for n, cnt in idx["refcount_histogram"].items())
    if hist:
        print(f"  refcount histogram: {hist}")
    for step, st in idx["per_step"].items():
        print(
            f"  {step}: {st['chunks']} chunks, {_human(st['new_bytes'])} new + "
            f"{_human(st['shared_bytes'])} shared"
        )
    return 0


def _cmd_manifest(args) -> int:
    from .snapshot import Snapshot

    print(json.dumps(json.loads(Snapshot(args.path).metadata.to_json()), indent=2))
    return 0


def _cmd_verify(args) -> int:
    from .snapshot import Snapshot
    from .verify import verify_snapshot

    res = verify_snapshot(Snapshot(args.path), deep=args.deep, rank=args.rank)
    print(str(res))
    return 0 if res.ok else 1


def _cmd_steps(args) -> int:
    from .manager import SnapshotManager

    mgr = SnapshotManager(args.root)
    steps = mgr.steps()
    for step in steps:
        print(f"{step}\t{mgr.path_for_step(step)}")
    if not steps:
        print("(no committed snapshots)", file=sys.stderr)
    return 0


def _cmd_tiers(args) -> int:
    """Residency and durability per step of a tiered manager root: which
    steps are fast-resident, which durably committed, and how many of
    each step's data objects each tier holds ("promoting": a write-back
    step whose durable marker has not landed yet)."""
    from .manager import SnapshotManager, entry_locations
    from .snapshot import Snapshot
    from .storage import url_to_storage_plugin

    mgr = SnapshotManager(args.root, tier={"fast_root": args.fast})

    def residency(storage_root, locations):
        """(objects present, their bytes) under ``storage_root``."""
        storage = url_to_storage_plugin(storage_root)
        present = nbytes = 0
        try:
            for loc in locations:
                try:
                    nbytes += storage.sync_stat(loc)
                    present += 1
                except Exception:  # noqa: BLE001 — absent either way
                    continue
        finally:
            storage.sync_close()
        return present, nbytes

    rows = []
    for step in sorted(set(mgr._read_index()) | set(mgr._scan_fs())):
        durable_path, fast_path = mgr.path_for_step(step), mgr.fast_path_for_step(step)
        metadata = None
        durable_committed = fast_committed = False
        try:
            metadata = Snapshot(durable_path).metadata
            durable_committed = True
        except Exception:  # noqa: BLE001 — not durably committed
            pass
        try:
            fast_metadata = Snapshot(fast_path).metadata
            fast_committed = True
            metadata = metadata or fast_metadata
        except Exception:  # noqa: BLE001 — no fast commit
            pass
        # chunk-referenced locations live in the pool, not per step
        chunked = ((metadata.cas or {}).get("chunks") or {}) if metadata else {}
        locations = (
            [loc for loc in entry_locations(metadata.manifest) if loc not in chunked]
            if metadata else []
        )
        fast_n, fast_b = residency(fast_path, locations)
        dur_n, dur_b = residency(durable_path, locations)
        status = (
            "durable+fast" if durable_committed and fast_n
            else "durable" if durable_committed
            else "promoting" if fast_committed
            else "aborted"
        )
        rows.append({
            "step": step,
            "status": status,
            "durable_committed": durable_committed,
            "fast_committed": fast_committed,
            "objects": len(locations),
            "fast_objects": fast_n,
            "fast_bytes": fast_b,
            "durable_objects": dur_n,
            "durable_bytes": dur_b,
        })
    if args.json:
        print(json.dumps({"root": args.root, "fast_root": args.fast, "steps": rows}, indent=2))
        return 0
    if not rows:
        print("(no snapshots found)", file=sys.stderr)
        return 0
    print(f"{'step':>10}  {'status':<13} {'fast':>14}  {'durable':>14}")
    for r in rows:
        fast_s = f"{r['fast_objects']}/{r['objects']} {_human(r['fast_bytes'])}"
        dur_s = f"{r['durable_objects']}/{r['objects']} {_human(r['durable_bytes'])}"
        print(f"{r['step']:>10}  {r['status']:<13} {fast_s:>14}  {dur_s:>14}")
    return 0


def _cmd_delete(args) -> int:
    from .manager import delete_snapshot

    if not args.yes:
        print("refusing to delete without --yes", file=sys.stderr)
        return 2
    delete_snapshot(args.path)
    print(f"deleted {args.path}")
    return 0


def _cmd_convert(args) -> int:
    """The original torchsnapshot format to the native one (a
    ``Snapshot.take`` of what ``read_torchsnapshot`` returns), or the
    reverse with ``--to-reference`` (``materialize`` into
    ``write_torchsnapshot``).  One rank's whole view passes through
    ``--device``; a snapshot of more than one rank needs ``--rank``,
    since other ranks' private state is not in a one-rank view."""
    from .snapshot import Snapshot
    from .stateful import PyTreeState
    from .tricks import peek_torchsnapshot, read_torchsnapshot, write_torchsnapshot

    def _require_rank(world_size: int) -> int:
        if world_size > 1 and args.rank is None:
            raise RuntimeError(
                f"snapshot was taken with world_size={world_size}; convert materializes ONE rank's view, "
                f"so other ranks' private per-rank state would be dropped. Pass --rank N to convert rank N's "
                f"view deliberately (replicated and sharded state is complete in any rank's view)."
            )
        rank = args.rank or 0
        if not 0 <= rank < world_size:
            # a grown-world view holds only replicated and sharded state
            raise RuntimeError(
                f"--rank {rank} is out of range for world_size={world_size} (valid: 0..{world_size - 1})"
            )
        return rank

    if args.to_reference:
        snap = Snapshot(args.src)
        rank = _require_rank(snap.metadata.world_size)
        write_torchsnapshot(args.dest, snap.materialize(rank=rank, device=args.device))
        print(f"exported {args.src} -> {args.dest} (reference format)")
        return 0
    metadata = peek_torchsnapshot(args.src)
    rank = _require_rank(int(metadata.get("world_size", 1)))
    state = read_torchsnapshot(args.src, rank=rank, metadata=metadata, device=args.device)
    Snapshot.take(args.dest, {k: PyTreeState(v) for k, v in state.items()})
    print(f"imported {args.src} -> {args.dest} (native format)")
    return 0


def _cmd_lint(args) -> int:
    """Run the snaplint static-analysis suite (tools/lint) over the repo
    checkout this package is running from; ``args`` is the raw argv tail
    forwarded to ``tools.lint.main``.  The suite is repo tooling, not
    part of the installed package: without a checkout this explains that
    instead of raising ImportError."""
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if not os.path.isdir(os.path.join(repo_root, "tools", "lint")):
        # no checkout (an installed package); when the directory exists,
        # import errors propagate with their own traceback
        print(
            "error: the lint suite (tools/lint) is repo tooling and "
            "needs a checkout — run from the repository root, or "
            "`python -m tools.lint` there",
            file=sys.stderr,
        )
        return 2
    if repo_root not in sys.path:
        sys.path.insert(0, repo_root)
    from tools.lint import main as lint_main

    return lint_main(list(args))


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "lint":
        # forwarded verbatim, before the parser (argparse.REMAINDER cannot
        # capture a leading option such as `lint --json`)
        return _cmd_lint(argv[1:])
    parser = argparse.ArgumentParser(prog="python -m torchsnapshot_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("ls", help="list a snapshot's logical entries")
    p.add_argument("path")
    p.set_defaults(fn=_cmd_ls)

    p = sub.add_parser("stats", help="size/dtype/chunk rollups from the manifest (no data reads)")
    p.add_argument("path")
    p.add_argument("--json", action="store_true", help="machine-readable output")
    p.add_argument("--top", type=int, default=10,
                   help="how many largest entries to list (default 10)")
    p.set_defaults(fn=_cmd_stats)

    p = sub.add_parser("doctor", help="render a snapshot's flight record (.snapshot_obsrecord)")
    p.add_argument("path")
    p.add_argument("--json", action="store_true", help="machine-readable output")
    p.add_argument("--diff", default=None, metavar="OTHER",
                   help="compare against OTHER snapshot's record (step-over-step)")
    p.set_defaults(fn=_cmd_doctor)

    p = sub.add_parser("trace", help="read the whole snapshot traced and profiled; write Perfetto JSON")
    p.add_argument("path")
    p.add_argument("--out", default=None, help="output file (default ./trace.json)")
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="where the leaves land (default cuda; cpu for host tensors)")
    p.set_defaults(fn=_cmd_trace)

    p = sub.add_parser("manifest", help="dump snapshot metadata as JSON")
    p.add_argument("path")
    p.set_defaults(fn=_cmd_manifest)

    p = sub.add_parser("verify", help="integrity audit (exit 1 on failure)")
    p.add_argument("path")
    p.add_argument("--deep", action="store_true",
                   help="re-read payloads against recorded checksums")
    p.add_argument("--rank", type=int, default=0)
    p.set_defaults(fn=_cmd_verify)

    p = sub.add_parser("steps", help="list a manager root's committed steps")
    p.add_argument("root")
    p.set_defaults(fn=_cmd_steps)

    p = sub.add_parser(
        "tiers",
        help="per-step tier residency + durability for a tiered manager "
        "root (fast copies, promotion progress)",
    )
    p.add_argument("root", help="durable-tier manager root")
    p.add_argument("--fast", required=True, help="fast-tier root")
    p.add_argument("--json", action="store_true", help="machine-readable output")
    p.set_defaults(fn=_cmd_tiers)

    p = sub.add_parser("cas", help="chunk-pool rollup, --fsck index rebuild, --gc mark+sweep")
    p.add_argument("root", help="the CAS root (<manager-root>/cas)")
    p.add_argument("--json", action="store_true", help="machine-readable output")
    p.add_argument("--fsck", action="store_true",
                   help="rebuild the index from committed manifests")
    p.add_argument("--gc", action="store_true", help="run the two-phase mark+sweep")
    p.add_argument("--grace", type=float, default=None,
                   help="override the GC grace window (seconds)")
    p.set_defaults(fn=_cmd_cas)

    p = sub.add_parser("delete", help="delete one snapshot (metadata-first)")
    p.add_argument("path")
    p.add_argument("--yes", action="store_true")
    p.set_defaults(fn=_cmd_delete)

    p = sub.add_parser(
        "convert",
        help="migrate a snapshot between the original torchsnapshot format and the native one "
        "(default: original -> native)",
    )
    p.add_argument("src")
    p.add_argument("dest")
    p.add_argument("--to-reference", action="store_true",
                   help="native -> original format (for handing back to reference-era torch jobs)")
    p.add_argument("--rank", type=int, default=None,
                   help="which rank's view to convert (required when world_size > 1; replicated/sharded "
                   "state is complete in any rank's view, but other ranks' private per-rank state is not "
                   "carried)")
    p.add_argument("--device", default="cuda",
                   help="where the leaves are held in between (default cuda; cpu for host tensors)")
    p.set_defaults(fn=_cmd_convert)

    # listed for --help; main() dispatches it before parsing
    sub.add_parser("lint", help="run the snaplint static-analysis suite (repo checkout only)")

    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except (FileNotFoundError, RuntimeError, ValueError) as e:
        # a missing, corrupt or aborted snapshot, or a dtype convert cannot
        # carry, prints one clean line
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
