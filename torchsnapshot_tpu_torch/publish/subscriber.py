"""Serving-side subscription: follow a publication root and hot-swap new
weights in without a cold restart.

Counterpart of ``torchsnapshot_tpu/publish/subscriber.py``.  A
``Subscriber`` owns one ``LiveWeights`` view of the serving process's
``app_state`` and advances it one published step at a time:

1. **Notice**: wait on the KV announce key up to a poll interval
   (``coordination.kv_watch``), then ALWAYS read the durable HEAD.  The
   announce is a latency hint: a lost one degrades to the durable poll,
   and a stale one cannot apply anything the root does not hold.
2. **Plan**: ``plan_delta`` against the held record, windowed to this
   subscriber's shard when a ``shard_spec`` is given.
3. **Fetch**: changed chunks only, grouped per base URL, through the
   scheduler's verified chunk reads (budget-admitted, keyed payloads
   checked against their keys, through the host cache).  With the
   collective transport in its local mode, a content-keyed chunk another
   subscriber of this process already fetched is taken from the engine's
   device registry (digest-verified) instead, and every chunk fetched
   from storage is published there for the next one.
4. **Apply**: stage, then swap under the generation lock
   (``apply.py``).

``poll_once`` is one pass; ``follow`` runs it on a daemon thread and
survives every error (counted in ``publish.watch_errors``, retried next
interval).  Each swap stamps ``subs/<sub_id>`` in the root
(best-effort), where the CLI's ``stats`` reads the fleet's lag.

``device`` (the card unless the caller names another) is where the
fan-in's payload parts live and where an array leaf with no live tensor
to follow lands; every other leaf lands where its live leaf is.

Differences from the reference, on purpose: an announce the non-blocking
precheck finds pending is recorded as delivered, so
``publish.fallback_polls`` counts only records the announce never
delivered (the reference also counts those the precheck saw);
``FollowHandle.stop`` logs a watcher that outlives its deadline.
"""

from __future__ import annotations

import logging
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

from .. import knobs, obs
from ..coordination import Coordinator, kv_watch
from ..io_types import StoragePlugin
from ..storage import url_to_storage_plugin
from . import announce as announce_mod
from .apply import LiveWeights
from .delta import DeltaPlan, FetchItem, plan_delta
from .record import PublishStore

logger = logging.getLogger(__name__)


class FollowHandle:
    """Returned by ``follow``: ``stop()`` ends the watcher thread (joined
    with a deadline) and is idempotent."""

    def __init__(self, thread: threading.Thread, stop_event: threading.Event) -> None:
        self._thread = thread
        self._stop = stop_event

    def stop(self, timeout_s: float = 30.0) -> None:
        self._stop.set()
        self._thread.join(timeout=timeout_s)
        if self._thread.is_alive():
            logger.warning("subscriber watcher %s still running after %.1f s", self._thread.name, timeout_s)

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()


class Subscriber:
    """See the module docstring."""

    def __init__(
        self,
        publish_root: str,
        app_state: Dict[str, Any],
        coordinator: Optional[Coordinator] = None,
        sub_id: Optional[str] = None,
        shard_spec: Optional[Dict[str, Tuple]] = None,
        poll_s: Optional[float] = None,
        priority: int = 0,
        strict: bool = True,
        device: Any = "cuda",
    ) -> None:
        self.root = publish_root.rstrip("/")
        self.live = LiveWeights(app_state, device=device)
        self.sub_id = sub_id or f"sub-{uuid.uuid4().hex[:12]}"
        self._coordinator = coordinator
        self._shard_spec = shard_spec
        self._poll_s = poll_s
        self._priority = int(priority)
        self._strict = strict
        self._device = device
        self._store = PublishStore(self.root)
        self._ns = announce_mod.ns_for_root(self.root)
        # serialises the engine (a caller's poll_once racing the follow
        # thread would fetch and apply one step twice); the blocking
        # waits stay outside it
        self._poll_lock = threading.Lock()
        self._held_record: Optional[Dict[str, Any]] = None
        self._last_announce: Optional[str] = None
        # fetch plugins per base URL, kept across polls (host cache on)
        self._fetch_storage: Dict[str, StoragePlugin] = {}
        self._bytes_fetched_total = 0
        self._closed = False
        # the chunk fan-in: the collective engine in local mode only
        # (the KV engine would put payload bytes on the coordination
        # service), resolved on first use
        self._transport: Any = None
        self._transport_resolved = False
        # (prefix, nparts) published last poll, swept at the next poll
        # or close so content-keyed entries do not pile up
        self._transport_pub: List[Tuple[str, int]] = []

    @property
    def step(self) -> Optional[int]:
        return self.live.step

    @property
    def generation(self) -> int:
        return self.live.generation

    def poll_interval_s(self) -> float:
        return self._poll_s if self._poll_s is not None else knobs.get_publish_poll_s()

    def poll_once(self, wait_s: float = 0.0) -> Optional[int]:
        """One notice → plan → fetch → apply pass; the new generation when
        a swap happened, None when already current.  ``wait_s`` > 0 first
        waits that long on the announce key (the follow loop's cadence);
        the durable HEAD decides either way."""
        if self._closed:
            raise RuntimeError("subscriber is closed")
        self._watch_announce(wait_s)
        head = self._store.read_head()
        if head is None:
            return None
        with self._poll_lock:
            held = self._held_record
            if held is not None and int(head["step"]) == int(held["step"]):
                return None
            with obs.span(
                "publish/poll", root=self.root, step=head["step"],
                held=None if held is None else held["step"],
            ):
                record = self._store.read_record(str(head["record"]))
                plan = plan_delta(record, held, self._shard_spec)
                fetched = self._fetch(record, plan)
                t0 = time.monotonic()
                gen = self.live.apply(record, plan, fetched, strict=self._strict)
                apply_s = time.monotonic() - t0
                self._held_record = record
                self._account(record, plan, apply_s)
                self._stamp(record, gen)
                return gen

    def follow(self, on_swap: Optional[Callable[[int, int], Any]] = None) -> FollowHandle:
        """Start the watcher thread: announce watch plus a durable poll
        every interval, surviving every error.  ``on_swap(step,
        generation)`` fires after each swap (its errors are swallowed
        too)."""
        stop = threading.Event()

        def _loop() -> None:
            while not stop.is_set():
                try:
                    gen = self.poll_once(wait_s=self.poll_interval_s())
                    if gen is not None and on_swap is not None:
                        on_swap(int(self.live.step), gen)
                except Exception as e:  # noqa: BLE001 — the watcher never dies: count, retry next interval
                    obs.counter(obs.PUBLISH_WATCH_ERRORS).inc()
                    obs.swallowed_exception("publish.subscriber.watch", e)
                    stop.wait(self.poll_interval_s())

        thread = threading.Thread(target=_loop, name=f"tsnp-subscriber-{self.sub_id}", daemon=True)
        thread.start()
        return FollowHandle(thread, stop)

    def close(self) -> None:
        """Release the fetch plugins, the fan-in's entries and the record
        store.  A ``follow`` thread is not stopped: stop its handle
        first."""
        if self._closed:
            return
        self._closed = True
        with self._poll_lock:
            storages = list(self._fetch_storage.values())
            self._fetch_storage.clear()
            transport, self._transport = self._transport, None
            if transport is not None:
                self._sweep_transport_pub(transport)
        for storage in storages:
            try:
                storage.sync_close()
            except Exception as e:  # noqa: BLE001 — teardown
                obs.swallowed_exception("publish.subscriber.close", e)
        if transport is not None:
            try:
                transport.close()
            except Exception as e:  # noqa: BLE001 — teardown
                obs.swallowed_exception("publish.subscriber.close", e)
        self._store.sync_close()

    def _watch_announce(self, wait_s: float) -> None:
        """Wait on the announce key up to ``wait_s``, remembering the raw
        value so the next watch waits for a change.  Latency only: the
        caller reads the durable HEAD whatever the announce said."""
        if wait_s <= 0:
            return
        if self._coordinator is None or not knobs.publish_announce_enabled():
            time.sleep(wait_s)  # no fast path: the durable poll is the cadence
            return
        with self._poll_lock:
            held = self._held_record
            held_step = None if held is None else int(held["step"])
            last = self._last_announce
        cur = announce_mod.current(self._coordinator, self._ns)
        if cur is not None and (held_step is None or cur[0] != held_step):
            # an announce is already pending: no wait, and it counts as
            # delivered (the reference leaves it unrecorded, so the swap
            # it announced counts in publish.fallback_polls)
            with self._poll_lock:
                self._last_announce = f"{cur[0]}:{cur[1]}"
            return
        raw = kv_watch(
            self._coordinator, announce_mod.announce_key(self._ns), last=last, timeout_s=wait_s
        )
        if raw is None:
            return
        with self._poll_lock:
            self._last_announce = raw
        # a malformed value (logged here) is a plain wake-up: the HEAD decides
        announce_mod.parse_announcement(raw)

    def _fanin_transport(self) -> Any:
        """The fan-in engine, or None (no coordinator, or an engine with no
        in-process registry).  Resolved once."""
        if not self._transport_resolved:
            self._transport_resolved = True
            if self._coordinator is not None:
                from ..transport import resolve_transport

                t = resolve_transport(self._coordinator, device=self._device)
                if getattr(t, "mode", None) == "local":
                    self._transport = t
        return self._transport

    def _fanin_prefix(self, key: str) -> str:
        # content-keyed: subscribers of one process meet on the same
        # prefix for the same chunk whichever leaf or step names it
        return f"{self._ns}/xfan/{key}"

    def _sweep_transport_pub(self, transport: Any) -> None:
        pub, self._transport_pub = self._transport_pub, []
        for prefix, nparts in pub:
            try:
                transport.cleanup(prefix, nparts)
            except Exception as e:  # noqa: BLE001 — best-effort sweep
                obs.swallowed_exception("publish.subscriber.fanin", e)

    def _fetch(self, record: Dict[str, Any], plan: DeltaPlan) -> Dict[Tuple[str, int], Any]:
        """Every planned chunk, ``(leaf, leaf_off) → bytes`` (see the
        module docstring).  Any fan-in anomaly sends that chunk to the
        durable path: fan-in saves bytes, never gates them."""
        if not plan.fetches:
            return {}
        from .. import scheduler

        transport = self._fanin_transport()
        if transport is not None:
            self._sweep_transport_pub(transport)
        by_base: Dict[str, List[FetchItem]] = {}
        fetched: Dict[Tuple[str, int], Any] = {}
        for item in plan.fetches:
            if transport is not None and item.key:
                try:
                    blob = transport.try_fetch(self._fanin_prefix(item.key))
                except Exception as e:  # noqa: BLE001 — registry miss, digest mismatch: durable path
                    obs.swallowed_exception("publish.subscriber.fanin", e)
                    blob = None
                # the collective engine hands back a bytearray
                if blob is not None and len(blob) == int(item.nbytes):
                    fetched[(item.leaf, item.leaf_off)] = blob
                    continue
            by_base.setdefault(item.base, []).append(item)
        for base, items in sorted(by_base.items()):
            storage = self._fetch_storage.get(base)
            if storage is None:
                storage = url_to_storage_plugin(base)
                self._fetch_storage[base] = storage
            blobs = scheduler.sync_execute_chunk_reads(
                [(it.path, it.byte_range, it.key, it.nbytes) for it in items],
                storage,
                scheduler.get_process_memory_budget_bytes(),
                priorities=[self._priority] * len(items),
                span_label="publish/fetch",
            )
            for item, blob in zip(items, blobs):
                fetched[(item.leaf, item.leaf_off)] = blob
                if transport is not None and item.key:
                    prefix = self._fanin_prefix(item.key)
                    try:
                        self._transport_pub.append((prefix, transport.publish(prefix, blob)))
                    except Exception as e:  # noqa: BLE001 — fan-in is pure savings for peers
                        obs.swallowed_exception("publish.subscriber.fanin", e)
        logger.debug(
            "publish fetch step=%s mode=%s: %d chunks, %d bytes from %d bases",
            record["step"], "cold" if self._held_record is None else "delta",
            len(fetched), sum(len(b) for b in fetched.values()), len(by_base),
        )
        return fetched

    def _account(self, record: Dict[str, Any], plan: DeltaPlan, apply_s: float) -> None:
        stats = plan.stats
        self._bytes_fetched_total += int(stats.get("bytes_fetch", 0))
        obs.counter(obs.PUBLISH_SUB_SWAPS).inc()
        obs.counter(obs.PUBLISH_SUB_BYTES_FETCHED).inc(int(stats.get("bytes_fetch", 0)))
        obs.counter(obs.PUBLISH_SUB_CHUNKS_FETCHED).inc(int(stats.get("chunks_fetch", 0)))
        obs.counter(obs.PUBLISH_SUB_CHUNKS_REUSED).inc(int(stats.get("chunks_reused", 0)))
        obs.histogram(obs.PUBLISH_SUB_APPLY_S).observe(apply_s)
        published_t = record.get("t")
        if published_t is not None:
            obs.histogram(obs.PUBLISH_SUB_LAG_S).observe(max(0.0, time.time() - float(published_t)))
        announced = announce_mod.parse_announcement(self._last_announce)
        if announced is None or announced[0] != int(record["step"]):
            # the durable poll delivered what the announce did not
            obs.counter(obs.PUBLISH_FALLBACK_POLLS).inc()

    def _stamp(self, record: Dict[str, Any], generation: int) -> None:
        self._store.write_stamp(
            self.sub_id,
            {
                "step": int(record["step"]),
                "generation": int(generation),
                "t": time.time(),
                "bytes_fetched": self._bytes_fetched_total,
            },
        )
