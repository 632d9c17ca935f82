"""Snapshot manifest schema: typed entries + metadata (de)serialization.

The port's own copy of ``torchsnapshot_tpu/manifest.py``: the schema is
the on-disk format both packages share, so the entry classes, their
``to_dict`` forms and the JSON rendering (``sort_keys``, the self-crc
trailer) are kept byte-for-byte.  ``ShardedArrayEntry`` is parsed so a
snapshot written by a sharded JAX job can be inspected; the port writes
it only from the multi-rank slice on.
"""

from __future__ import annotations

import json
from base64 import b64decode, b64encode
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

from .utils.selfcrc import append_crc_trailer, strip_crc_trailer

MANIFEST_VERSION = "0.1.0"

# Self-checksum trailer appended to the serialized metadata FILE (not
# part of the JSON document).  Payload entries carry per-object digests,
# but without this the manifest itself was the one unprotected byte
# range in a snapshot: a flipped shape digit or location character would
# mislead every restore (the reference has the same gap).  The marker
# starts with a newline + '#': json.dumps escapes newlines inside
# strings, so the raw sequence can never occur within the JSON body; a
# plain-YAML reader treats the trailer as a comment.
_META_CRC_MARKER = "\n#tsnp-meta-crc32:"


@dataclass
class Entry:
    """Base class for all manifest entries; ``type`` is the dispatch tag."""

    type: str

    def to_dict(self) -> Dict[str, Any]:
        d = dict(self.__dict__)
        return d


@dataclass(init=False)
class ArrayEntry(Entry):
    """A single logical array stored as one blob (reference TensorEntry,
    manifest.py:49-95)."""

    location: str
    serializer: str
    dtype: str
    shape: List[int]
    replicated: bool
    byte_range: Optional[List[int]]  # [start, end) within location, or None

    def __init__(
        self,
        location: str,
        serializer: str,
        dtype: str,
        shape: List[int],
        replicated: bool,
        byte_range: Optional[List[int]] = None,
        crc32: Optional[int] = None,
    ) -> None:
        super().__init__(type="Array")
        self.location = location
        self.serializer = serializer
        self.dtype = dtype
        self.shape = shape
        self.replicated = replicated
        self.byte_range = byte_range
        # zlib.crc32 of the serialized payload, recorded at staging time
        # (knobs WRITE_CHECKSUMS); checked by verify(deep=True)
        self.crc32 = crc32

    def to_dict(self) -> Dict[str, Any]:
        d = super().to_dict()
        if d.get("byte_range") is None:
            del d["byte_range"]
        if d.get("crc32") is None:
            del d["crc32"]
        return d


@dataclass
class Shard:
    """A hyperrectangular region of a global array: ``offsets``/``sizes`` per
    dim, stored at ``location`` (reference Shard, manifest.py:96-117)."""

    offsets: List[int]
    sizes: List[int]
    location: str
    byte_range: Optional[List[int]] = None
    crc32: Optional[int] = None

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "offsets": self.offsets,
            "sizes": self.sizes,
            "location": self.location,
        }
        if self.byte_range is not None:
            d["byte_range"] = self.byte_range
        if self.crc32 is not None:
            d["crc32"] = self.crc32
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Shard":
        return cls(
            offsets=list(d["offsets"]),
            sizes=list(d["sizes"]),
            location=d["location"],
            byte_range=list(d["byte_range"]) if d.get("byte_range") else None,
            crc32=d.get("crc32"),
        )


@dataclass(init=False)
class ShardedArrayEntry(Entry):
    """A sharded ``jax.Array``: global shape/dtype + concrete shard boxes +
    (optional) the mesh/PartitionSpec it was saved under.

    Subsumes the reference's ShardedTensorEntry (manifest.py:118-170) and
    DTensorEntry (manifest.py:211-334): ``spec`` is the direct analogue of
    DTensor's ``dim_map`` — a per-dim assignment of zero or more mesh axes —
    and mesh axes absent from ``spec`` define the replica sets.
    """

    dtype: str
    shape: List[int]  # global shape
    shards: List[Shard]
    mesh_axis_names: Optional[List[str]]
    mesh_shape: Optional[List[int]]
    # PartitionSpec, JSON-ified: one element per dim; each element is
    # None | axis-name | [axis-name, ...]
    spec: Optional[List[Any]]

    def __init__(
        self,
        dtype: str,
        shape: List[int],
        shards: List[Shard],
        mesh_axis_names: Optional[List[str]] = None,
        mesh_shape: Optional[List[int]] = None,
        spec: Optional[List[Any]] = None,
    ) -> None:
        super().__init__(type="ShardedArray")
        self.dtype = dtype
        self.shape = shape
        self.shards = shards
        self.mesh_axis_names = mesh_axis_names
        self.mesh_shape = mesh_shape
        self.spec = spec

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "type": self.type,
            "dtype": self.dtype,
            "shape": self.shape,
            "shards": [s.to_dict() for s in self.shards],
        }
        if self.mesh_axis_names is not None:
            d["mesh_axis_names"] = self.mesh_axis_names
            d["mesh_shape"] = self.mesh_shape
            d["spec"] = self.spec
        return d


@dataclass(init=False)
class ChunkedArrayEntry(Entry):
    """A big unsharded array split into dim-0 chunks for pipelined I/O
    (reference ChunkedTensorEntry, manifest.py:171-210)."""

    dtype: str
    shape: List[int]
    chunks: List[Shard]
    replicated: bool

    def __init__(
        self, dtype: str, shape: List[int], chunks: List[Shard], replicated: bool
    ) -> None:
        super().__init__(type="ChunkedArray")
        self.dtype = dtype
        self.shape = shape
        self.chunks = chunks
        self.replicated = replicated

    def to_dict(self) -> Dict[str, Any]:
        return {
            "type": self.type,
            "dtype": self.dtype,
            "shape": self.shape,
            "chunks": [c.to_dict() for c in self.chunks],
            "replicated": self.replicated,
        }


@dataclass(init=False)
class ObjectEntry(Entry):
    """An arbitrary Python object serialized by the object codec
    (reference ObjectEntry, manifest.py:335+).

    ``byte_range`` makes object payloads slab-eligible like array
    payloads: a checkpoint with thousands of tiny object leaves (e.g.
    numpy scalars in optimizer state) coalesces into a handful of
    storage objects, and their restore reads merge into spanning reads.
    Absent/None for pre-round-4 snapshots and unslabbed objects."""

    location: str
    serializer: str
    replicated: bool
    crc32: Optional[int]
    byte_range: Optional[List[int]]

    def __init__(
        self,
        location: str,
        serializer: str,
        replicated: bool,
        crc32: Optional[int] = None,
        byte_range: Optional[List[int]] = None,
    ) -> None:
        super().__init__(type="object")
        self.location = location
        self.serializer = serializer
        self.replicated = replicated
        self.crc32 = crc32
        self.byte_range = byte_range

    def to_dict(self) -> Dict[str, Any]:
        d = super().to_dict()
        if d.get("crc32") is None:
            del d["crc32"]
        if d.get("byte_range") is None:
            del d["byte_range"]
        return d


_PRIMITIVE_TYPES = ("int", "float", "str", "bool", "bytes", "NoneType")


@dataclass(init=False)
class PrimitiveEntry(Entry):
    """Small primitive inlined into the metadata file — no storage I/O
    (reference PrimitiveEntry, manifest.py:335-441)."""

    readable: str
    replicated: bool

    def __init__(self, type: str, readable: str, replicated: bool) -> None:
        super().__init__(type=type)
        self.readable = readable
        self.replicated = replicated

    @classmethod
    def from_object(cls, obj: Any, replicated: bool) -> "PrimitiveEntry":
        t = type(obj).__name__
        if t not in _PRIMITIVE_TYPES:
            raise TypeError(f"not a supported primitive: {type(obj)}")
        if t == "bytes":
            readable = b64encode(obj).decode("ascii")
        elif t == "float":
            readable = repr(obj)  # round-trippable
        elif t == "NoneType":
            readable = ""
        else:
            readable = str(obj)
        return cls(type=t, readable=readable, replicated=replicated)

    def get_value(self) -> Any:
        t = self.type
        if t == "int":
            return int(self.readable)
        if t == "float":
            return float(self.readable)
        if t == "str":
            return self.readable
        if t == "bool":
            return self.readable == "True"
        if t == "bytes":
            return b64decode(self.readable.encode("ascii"))
        if t == "NoneType":
            return None
        raise ValueError(f"unknown primitive type {t}")


def is_primitive_type(obj: Any) -> bool:
    # bool must be checked before int (bool is a subclass of int)
    return type(obj).__name__ in _PRIMITIVE_TYPES


@dataclass(init=False)
class DictEntry(Entry):
    """Container entry preserving key order and key types (str vs int)
    (reference DictEntry, manifest.py)."""

    keys: List[Union[str, int]]

    def __init__(self, keys: List[Union[str, int]], type: str = "dict") -> None:
        super().__init__(type=type)
        self.keys = keys


class OrderedDictEntry(DictEntry):
    def __init__(self, keys: List[Union[str, int]]) -> None:
        super().__init__(keys=keys, type="OrderedDict")


@dataclass(init=False)
class ListEntry(Entry):
    """List container; records its length so partial/elastic restores can
    distinguish a missing element from the end of the list (the reference's
    ListEntry relies on index scanning alone)."""

    length: int

    def __init__(self, length: int = 0, type: str = "list") -> None:
        super().__init__(type=type)
        self.length = length


class TupleEntry(ListEntry):
    """Tuples are first-class containers here (JAX pytrees are tuple-heavy;
    the reference only handles dict/list/OrderedDict)."""

    def __init__(self, length: int = 0) -> None:
        super().__init__(length=length, type="tuple")


Manifest = Dict[str, Entry]


def is_container_entry(entry: Entry) -> bool:
    return isinstance(entry, (DictEntry, ListEntry))


def entry_from_dict(d: Dict[str, Any]) -> Entry:
    t = d["type"]
    if t == "Array":
        return ArrayEntry(
            location=d["location"],
            serializer=d["serializer"],
            dtype=d["dtype"],
            shape=list(d["shape"]),
            replicated=bool(d["replicated"]),
            byte_range=list(d["byte_range"]) if d.get("byte_range") else None,
            crc32=d.get("crc32"),
        )
    if t == "ShardedArray":
        return ShardedArrayEntry(
            dtype=d["dtype"],
            shape=list(d["shape"]),
            shards=[Shard.from_dict(s) for s in d["shards"]],
            mesh_axis_names=d.get("mesh_axis_names"),
            mesh_shape=list(d["mesh_shape"]) if d.get("mesh_shape") else None,
            spec=d.get("spec"),
        )
    if t == "ChunkedArray":
        return ChunkedArrayEntry(
            dtype=d["dtype"],
            shape=list(d["shape"]),
            chunks=[Shard.from_dict(s) for s in d["chunks"]],
            replicated=bool(d["replicated"]),
        )
    if t == "object":
        return ObjectEntry(
            location=d["location"],
            serializer=d["serializer"],
            replicated=bool(d["replicated"]),
            crc32=d.get("crc32"),
            byte_range=list(d["byte_range"]) if d.get("byte_range") else None,
        )
    if t in _PRIMITIVE_TYPES:
        return PrimitiveEntry(
            type=t, readable=d["readable"], replicated=bool(d["replicated"])
        )
    if t == "dict":
        return DictEntry(keys=list(d["keys"]))
    if t == "OrderedDict":
        return OrderedDictEntry(keys=list(d["keys"]))
    if t == "list":
        return ListEntry(length=int(d.get("length", 0)))
    if t == "tuple":
        return TupleEntry(length=int(d.get("length", 0)))
    raise ValueError(f"unknown manifest entry type: {t!r}")


@dataclass
class SnapshotMetadata:
    """The root metadata document (reference SnapshotMetadata,
    manifest.py:442-475)."""

    version: str
    world_size: int
    manifest: Manifest = field(default_factory=dict)
    # location → [crc32, adler32, size] of the whole stored object
    # (slabs included); written when WRITE_CHECKSUMS is on.  This is
    # what incremental takes compare against: a staged object whose
    # digest matches the base snapshot's object at the same location is
    # linked, not rewritten.  Two independent checksums + exact length
    # so one 32-bit collision can't silently dedup changed content.
    # NOTE under compression (codec.py) these digests stay RAW-byte
    # digests — dedup and deep-verify semantics are codec-invariant; the
    # STORED-byte digest lives in the codecs table below.
    objects: Dict[str, List[int]] = field(default_factory=dict)
    # location → codec frame table for objects stored compressed
    # (codec.make_table: codec name, raw part size, raw size, per-frame
    # stored lengths, stored-byte digest).  ABSENT location ⇒ the object
    # is stored raw — which makes every pre-codec-era snapshot (no
    # "codecs" key at all) restore through the unchanged raw path.
    codecs: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    # Content-addressed chunk refs (cas/): {"root": <cas root, relative
    # "../cas" under a manager layout>, "chunks": {location → chunk
    # table (cas.make_table: chunk_size, raw size, ordered content
    # keys)}}.  A location present here has NO per-step storage object —
    # its raw byte stream assembles from the shared chunk pool; raw
    # digests in ``objects`` above are preserved, so dedup comparisons
    # and deep-verify stay bitwise-identical.  ABSENT key ⇒ pre-CAS
    # snapshot: every read goes through the unchanged per-step path.
    cas: Dict[str, Any] = field(default_factory=dict)
    # Degraded-commit record (resilience/liveness.py + the take path's
    # write takeover): logical path → {"origin_rank": <dead rank>,
    # "kind": <entry type>} for state only a rank that DIED mid-take
    # held (per-rank/sharded payloads that no survivor could re-write).
    # The snapshot is committed and restorable for every other path;
    # restores touching a listed path raise a typed
    # DegradedSnapshotError, verify/doctor/stats surface the set, and
    # repair (Snapshot.repair_degraded / SnapshotManager.repair) or the
    # next take removes entries as they heal.  ABSENT key ⇒ a complete
    # snapshot — the invariant every pre-liveness snapshot satisfies.
    degraded: Dict[str, Dict[str, Any]] = field(default_factory=dict)

    def to_json(self) -> str:
        d = {
            "version": self.version,
            "world_size": self.world_size,
            "manifest": {k: v.to_dict() for k, v in self.manifest.items()},
        }
        if self.objects:
            d["objects"] = self.objects
        if self.codecs:
            d["codecs"] = self.codecs
        if self.cas:
            d["cas"] = self.cas
        if self.degraded:
            d["degraded"] = self.degraded
        return json.dumps(d, sort_keys=True)

    # JSON is a YAML subset; emit JSON for speed, accept YAML on read
    # (reference manifest.py:442-475).  The stored FILE additionally
    # carries the self-checksum trailer; ``to_json`` stays the pure
    # document form (used for display / tests).
    def to_yaml(self) -> str:
        return append_crc_trailer(self.to_json(), _META_CRC_MARKER)

    @classmethod
    def from_yaml(cls, s: str) -> "SnapshotMetadata":
        # shared trailer discipline (utils/selfcrc.py): strict %08x hex,
        # every-bit-flip-fails, and a trailer-SHAPED final line that
        # fails the marker match is corruption — never a silent
        # downgrade to the unverified legacy parse.  (Hand-written YAML
        # ending in a comment line is rejected with a clear error — an
        # accepted trade against a silent integrity downgrade.)
        s, _ = strip_crc_trailer(
            s, _META_CRC_MARKER, "metadata", ".snapshot_metadata"
        )
        # legacy/hand-written/plain-YAML metadata file — parse as
        # before, no self-check available
        try:
            d = json.loads(s)
        except json.JSONDecodeError:
            import yaml

            try:
                loader = yaml.CSafeLoader  # type: ignore[attr-defined]
            except AttributeError:
                loader = yaml.SafeLoader
            d = yaml.load(s, Loader=loader)
        manifest = {k: entry_from_dict(v) for k, v in d["manifest"].items()}
        return cls(
            version=d["version"],
            world_size=int(d["world_size"]),
            manifest=manifest,
            objects={
                k: ([int(x) for x in v] if isinstance(v, list) else [int(v)])
                for k, v in (d.get("objects") or {}).items()
            },
            codecs={
                k: dict(v)
                for k, v in (d.get("codecs") or {}).items()
                if isinstance(v, dict)
            },
            cas=(
                dict(d["cas"]) if isinstance(d.get("cas"), dict) else {}
            ),
            degraded={
                k: dict(v)
                for k, v in (d.get("degraded") or {}).items()
                if isinstance(v, dict)
            },
        )

    from_json = from_yaml
