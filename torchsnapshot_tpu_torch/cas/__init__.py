"""Content-addressed chunk store: chunk-level incremental snapshots with
refcounted GC.

Counterpart of ``torchsnapshot_tpu/cas/``, with the same on-disk pool.
Payload bytes are stored as content-keyed chunks in a pool shared by a
root's steps (``<root>/cas``); a take skips the writes of chunks a
committed step already stored, the manifest records chunk references
(the raw digests kept, so dedup and deep verification stay bitwise), and
retention releases references, so any step can be deleted.

- ``store``: chunk keys and paths, ``ChunkStore``, the chunked and
  streamed writes and the assembling read.
- ``index``: the refcounted, self-checksummed ``index.json`` and
  ``fsck`` (a rebuild from the committed manifests).
- ``gc``: ref registration at commit, release on delete, mark and sweep.
"""

from .gc import commit_refs, release_step, run_gc  # noqa: F401
from .index import (  # noqa: F401
    CHUNK_INDEX_FNAME,
    ChunkIndex,
    ChunkIndexCorruptError,
    ChunkIndexLockTimeout,
    chunk_tables_from_metadata,
    fsck,
    norm_ref,
)
from .store import (  # noqa: F401
    CasWriteContext,
    ChunkStore,
    cas_streamed_write,
    chunk_key,
    chunk_location,
    chunked_read,
    chunked_write,
    diff_tables,
    key_size,
    make_table,
    record_root,
    resolve_root,
    validate_table,
)
