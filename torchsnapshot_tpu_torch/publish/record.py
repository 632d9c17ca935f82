"""Publication records: the self-CRC'd, marker-last contract between a
training job and a serving fleet.

Counterpart of ``torchsnapshot_tpu/publish/record.py``, in its format
(either package reads the other's roots).  A record names one published
step as pure references: for every logical leaf of the flattened state,
an ordered list of byte refs that concatenate to the leaf's raw bytes.
A ref is

``{"k": <content key|None>, "b": <base index>, "p": <path>,
   "o": [lo, hi]|None, "n": <bytes>}``

``b`` indexes the record's ``bases`` (storage root URLs), ``p`` is the
object path under that base, ``o`` an optional extent inside the object
(a slab member), and ``k`` the chunk store's crc32-adler32-size key when
the source is content-addressed.  Two records' refs at the same leaf
offset with the same key are the same bytes, which is what lets a
subscriber fetch only what changed; un-keyed refs are re-fetched
whenever their ``(base, path, extent)`` identity changes.

The body lands at ``records/<step>.json`` first, then the HEAD marker
(``.snapshot_metadata``, format-tagged so no snapshot or continuous
parser takes it for its own) names it durably, so a publisher killed
between the two leaves subscribers on the previous complete record.
Both documents, and the subscribers' heartbeat stamps under ``subs/``,
carry the self-CRC trailer.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

from .. import obs
from ..cas.store import key_size
from ..io_types import ReadIO, StoragePlugin, WriteIO
from ..utils.selfcrc import append_crc_trailer, strip_crc_trailer

RECORD_FORMAT = "tsnp-publication"
HEAD_FORMAT = "tsnp-publication-head"
# the repo-wide marker name ("marker present == root complete"); the
# format tag keeps discovery code from parsing it as a snapshot's
HEAD_FNAME = ".snapshot_metadata"
SUBS_DIR = "subs"
_CRC_MARKER = "\n# tsnp-publication-crc32: "


def record_path(step: int) -> str:
    return f"records/{int(step):010d}.json"


def stamp_path(sub_id: str) -> str:
    return f"{SUBS_DIR}/{sub_id}.json"


def make_ref(
    key: Optional[str],
    base: int,
    path: str,
    byte_range: Optional[List[int]] = None,
    nbytes: Optional[int] = None,
) -> Dict[str, Any]:
    """One leaf byte ref; a keyed ref may leave ``nbytes`` out (its key
    carries the length)."""
    if nbytes is None:
        if key is None:
            raise ValueError("un-keyed refs must carry an explicit nbytes")
        nbytes = key_size(key)
    return {
        "k": key,
        "b": int(base),
        "p": path,
        "o": list(byte_range) if byte_range is not None else None,
        "n": int(nbytes),
    }


def ref_nbytes(ref: Dict[str, Any]) -> int:
    return int(ref["n"])


def build_record(
    step: int,
    source: str,
    bases: List[str],
    leaves: Dict[str, Dict[str, Any]],
    stats: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """One publication record.  ``leaves`` maps logical path → the
    continuous store's leaf fields (kind/dtype/shape/size or
    kind/tag/size) plus ``refs``.  Raises ``ValueError`` when a leaf's
    refs do not tile its size: such a record could not rebuild its own
    leaves."""
    for path, leaf in leaves.items():
        total = sum(ref_nbytes(r) for r in leaf["refs"])
        if total != int(leaf["size"]):
            raise ValueError(
                f"publication leaf {path!r} declares {leaf['size']} bytes but its refs tile {total}"
            )
    return {
        "format": RECORD_FORMAT,
        "version": 1,
        "step": int(step),
        "source": source,
        "t": time.time(),
        "bases": list(bases),
        "leaves": leaves,
        "stats": dict(stats or {}),
    }


def encode_record(record: Dict[str, Any]) -> bytes:
    return append_crc_trailer(json.dumps(record, sort_keys=True), _CRC_MARKER).encode()


def encode_head(step: int) -> bytes:
    body = json.dumps(
        {"format": HEAD_FORMAT, "version": 1, "step": int(step), "record": record_path(step)},
        sort_keys=True,
    )
    return append_crc_trailer(body, _CRC_MARKER).encode()


def _decode_doc(data: Any, label: str, fname: str) -> Dict[str, Any]:
    text = bytes(memoryview(data).cast("B")).decode()
    body, had = strip_crc_trailer(text, _CRC_MARKER, label, fname)
    if not had:
        raise RuntimeError(
            f"{label} {fname!r} has no integrity trailer — not a publication document"
        )
    return json.loads(body)


class PublishStore:
    """Verified I/O against one publication root (any storage URL);
    paths and format only.  The root's storage skips the shared-host
    cache: the HEAD is the protocol's one mutable object and must never
    be served stale."""

    def __init__(self, root: str, storage: Optional[StoragePlugin] = None) -> None:
        self.root = root.rstrip("/")
        self._storage = storage

    @property
    def storage(self) -> StoragePlugin:
        if self._storage is None:
            from ..storage import url_to_storage_plugin

            self._storage = url_to_storage_plugin(self.root, {"host_cache": False})
        return self._storage

    def read_head(self) -> Optional[Dict[str, Any]]:
        """The verified HEAD, or None when nothing is published yet.
        Corruption raises."""
        try:
            io = ReadIO(path=HEAD_FNAME)
            self.storage.sync_read(io)
        except FileNotFoundError:
            return None
        doc = _decode_doc(io.buf, "publication HEAD", HEAD_FNAME)
        if doc.get("format") != HEAD_FORMAT:
            raise RuntimeError(
                f"{self.root}/{HEAD_FNAME} is not a publication HEAD (format={doc.get('format')!r})"
            )
        return doc

    def read_record(self, path: str) -> Dict[str, Any]:
        io = ReadIO(path=path)
        self.storage.sync_read(io)
        doc = _decode_doc(io.buf, "publication record", path)
        if doc.get("format") != RECORD_FORMAT:
            raise RuntimeError(f"{self.root}/{path} is not a publication record")
        return doc

    def read_stamps(self) -> Dict[str, Dict[str, Any]]:
        """Every subscriber's heartbeat stamp (id → doc).  Local roots
        only (storage plugins cannot list); unreadable or corrupt stamps
        are skipped, so a dying subscriber's torn stamp never breaks the
        fleet view."""
        out: Dict[str, Dict[str, Any]] = {}
        if "://" in self.root and not self.root.startswith("file://"):
            return out
        base = self.root.split("://", 1)[-1]
        try:
            names = sorted(os.listdir(os.path.join(base, SUBS_DIR)))
        except OSError:
            return out  # no subscriber has stamped yet
        for name in names:
            if not name.endswith(".json"):
                continue
            try:
                io = ReadIO(path=f"{SUBS_DIR}/{name}")
                self.storage.sync_read(io)
                out[name[: -len(".json")]] = _decode_doc(io.buf, "subscriber stamp", name)
            except Exception as e:  # noqa: BLE001 — advisory telemetry
                obs.swallowed_exception("publish.store.read_stamp", e)
        return out

    def write_record(self, record: Dict[str, Any]) -> str:
        """Marker-last commit of one record (body, then HEAD durably);
        returns the record path."""
        path = record_path(record["step"])
        self.storage.sync_write(WriteIO(path=path, buf=encode_record(record)))
        self.storage.sync_write(
            WriteIO(path=HEAD_FNAME, buf=encode_head(record["step"]), durable=True)
        )
        return path

    def write_stamp(self, sub_id: str, doc: Dict[str, Any]) -> None:
        """Best-effort heartbeat stamp: telemetry never fails the swap it
        reports."""
        try:
            body = append_crc_trailer(json.dumps(doc, sort_keys=True), _CRC_MARKER).encode()
            self.storage.sync_write(WriteIO(path=stamp_path(sub_id), buf=body))
        except Exception as e:  # noqa: BLE001 — best-effort by contract
            obs.swallowed_exception("publish.store.write_stamp", e)

    def delete_quiet(self, path: str) -> None:
        try:
            self.storage.sync_delete(path)
        except Exception as e:  # noqa: BLE001 — best-effort cleanup
            obs.swallowed_exception("publish.store.delete", e)

    def sync_close(self) -> None:
        if self._storage is not None:
            self._storage.sync_close()
            self._storage = None


def root_rollup(root: str) -> Optional[Dict[str, Any]]:
    """The CLI's rollup of one publication root, or None when ``root``
    is not one: the HEAD, the last record's stats, and per subscriber
    how many steps and seconds it trails the HEAD."""
    store = PublishStore(root)
    try:
        try:
            head = store.read_head()
        except FileNotFoundError:
            return None
        except Exception as e:  # noqa: BLE001 — not a publication root
            obs.swallowed_exception("publish.rollup.head", e)
            return None
        if head is None:
            return None
        out: Dict[str, Any] = {"root": root, "step": int(head["step"]), "record": head["record"]}
        try:
            rec = store.read_record(str(head["record"]))
            out["source"] = rec.get("source")
            out["published_t"] = rec.get("t")
            out["leaves"] = len(rec.get("leaves") or {})
            out["stats"] = rec.get("stats") or {}
        except Exception as e:  # noqa: BLE001 — a HEAD mid-prune or corrupt: report what is known
            obs.swallowed_exception("publish.rollup.record", e)
            out["record_error"] = f"{e!r}"[:200]
        subs = []
        now = time.time()
        for sub_id, stamp in sorted(store.read_stamps().items()):
            try:
                subs.append(
                    {
                        "id": sub_id,
                        "step": int(stamp["step"]),
                        "generation": int(stamp.get("generation", 0)),
                        "lag_steps": int(head["step"]) - int(stamp["step"]),
                        "age_s": round(max(0.0, now - float(stamp.get("t", now))), 3),
                        "bytes_fetched": int(stamp.get("bytes_fetched", 0)),
                    }
                )
            except (KeyError, TypeError, ValueError):
                subs.append({"id": sub_id, "malformed": True})
        out["subscribers"] = subs
        return out
    finally:
        store.sync_close()
