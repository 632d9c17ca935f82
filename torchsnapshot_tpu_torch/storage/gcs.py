"""Google Cloud Storage plugin (``gs://<bucket>/<prefix>``).

Counterpart of ``torchsnapshot_tpu/storage/gcs.py``, on
``google-cloud-storage``'s sync client driven from a thread pool, with
the same blob names, so either package restores the other's GCS
snapshots and sweeps the other's leftover part blobs.  The client
library is imported in ``__init__``, never with this module.

- Objects over ``chunk_bytes`` (100 MB) go up as a parallel composite
  upload: part blobs ``<name>.part-NNNNN``, each under its own retry,
  joined by ``compose`` (hierarchically past 32 components, through
  ``<name>.compose-<level>-NNNNN``), every intermediate swept after,
  whether the upload succeeded or not.  The stripe engine drives the
  same parts through ``_GCSStripedWriteHandle``.
- Reads: a blob within one chunk is one ranged GET; a larger one is
  parallel ranged GETs of ``chunk_bytes`` each, pinned to the
  generation a stat saw, so a concurrent overwrite fails the read
  instead of splicing two generations.
- A 404 is ``FileNotFoundError`` for reads and stats, a success for
  deletes, and a transient for writes (GCS invalidating a resumable
  session mid-upload shows as 404).  A 416 on a read (a zero-byte
  object) raises at once; a whole read maps it to an empty object.
- All operations share one progress window (``SharedProgress``, exported
  as ``_CollectiveProgressRetry`` as the JAX module does): an operation
  gives up only when no operation of the plugin has completed for the
  window.  Writes feed the ``gcs`` breaker; failpoints
  ``storage.gcs.<kind>`` (``write``, ``read``, ``delete``) and
  ``storage.gcs.part.write`` sit inside the retried calls.
"""

from __future__ import annotations

import asyncio
import functools
import io
import logging
from concurrent.futures import ThreadPoolExecutor

from .. import obs
from ..io_types import ReadIO, StoragePlugin, StripedWriteHandle, WriteIO
from ..resilience import MISSING, RAISE, SUCCESS_NONE, TRANSIENT, SharedProgress, get_breaker, retry_call
from ..resilience.failpoints import failpoint

logger = logging.getLogger(__name__)

_DEFAULT_CHUNK_BYTES = 100 * 1024 * 1024
_MAX_COMPOSE_COMPONENTS = 32  # GCS's limit per compose call

_CollectiveProgressRetry = SharedProgress


def _is_not_found(e: BaseException) -> bool:
    try:
        from google.api_core import exceptions as gexc

        if isinstance(e, gexc.NotFound):
            return True
    except ImportError:
        pass
    return type(e).__name__ == "NotFound" or getattr(e, "code", None) == 404


def _is_range_unsatisfiable(e: BaseException) -> bool:
    # a ranged GET at or past the end: only a zero-byte object gives it
    # for the plugin's chunk-aligned ranges
    return type(e).__name__ == "RequestedRangeNotSatisfiable" or getattr(e, "code", None) == 416


class _MemoryviewStream(io.RawIOBase):
    """A seekable readable stream over a memoryview: the client uploads
    from the staged buffer with no copy of it.  One upload call owns a
    stream at a time."""

    def __init__(self, view) -> None:
        self._view = memoryview(view).cast("B")
        self._pos = 0

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def readinto(self, b) -> int:
        n = min(len(b), self._view.nbytes - self._pos)
        if n <= 0:
            return 0
        b[:n] = self._view[self._pos : self._pos + n]
        self._pos += n
        return n

    def read(self, size: int = -1) -> bytes:
        if size is None or size < 0:
            size = self._view.nbytes - self._pos
        n = max(0, min(size, self._view.nbytes - self._pos))
        out = bytes(self._view[self._pos : self._pos + n])
        self._pos += n
        return out

    def seek(self, pos: int, whence: int = io.SEEK_SET) -> int:
        base = {io.SEEK_SET: 0, io.SEEK_CUR: self._pos, io.SEEK_END: self._view.nbytes}.get(whence)
        if base is None:
            raise ValueError(f"invalid whence {whence}")
        self._pos = max(0, min(base + pos, self._view.nbytes))
        return self._pos

    def tell(self) -> int:
        return self._pos

    def __len__(self) -> int:
        return self._view.nbytes


def _upload(blob, view: memoryview) -> None:
    # streamed from the staged buffer; crc32c checked by the server
    blob.upload_from_file(_MemoryviewStream(view), size=view.nbytes, rewind=True, checksum="crc32c")


@obs.instrument_storage("gcs")
class GCSStoragePlugin(StoragePlugin):
    supports_striped_write = True

    def __init__(self, path: str, num_threads: int = 16, chunk_bytes: int = _DEFAULT_CHUNK_BYTES) -> None:
        try:
            from google.cloud import storage as gcs
        except ImportError as e:
            raise RuntimeError("gs:// support requires google-cloud-storage") from e
        bucket_name, _, self.prefix = path.partition("/")
        self._client = gcs.Client()
        self._bucket = self._client.bucket(bucket_name)
        self._executor = ThreadPoolExecutor(max_workers=num_threads, thread_name_prefix="tsnp-gcs")
        self._retry = SharedProgress(label="gcs")
        self._chunk_bytes = chunk_bytes

    def _blob_name(self, path: str) -> str:
        return f"{self.prefix}/{path}" if self.prefix else path

    async def _with_retry(self, fn, op_name: str):
        """``op_name`` starts with its kind (``write``, ``read`` or
        ``delete``), which picks the failpoint and what a 404 means."""
        kind = op_name.split(" ", 1)[0]

        def attempt():
            failpoint(f"storage.gcs.{kind}", op=op_name)
            return fn()

        def classify(e: BaseException) -> str:
            if _is_not_found(e):
                return {"delete": SUCCESS_NONE, "write": TRANSIENT}.get(kind, MISSING)
            if _is_range_unsatisfiable(e) and kind == "read":
                return RAISE
            return TRANSIENT

        return await retry_call(
            attempt, op_name=op_name, backend="gcs", classify=classify, progress=self._retry,
            executor=self._executor, breaker=get_breaker("gcs") if kind == "write" else None,
        )

    # ------------------------------------------------------------- write

    async def write(self, write_io: WriteIO) -> None:
        view = memoryview(write_io.buf).cast("B")
        if view.nbytes > self._chunk_bytes:
            await self._chunked_write(write_io.path, view)
            return
        blob = self._bucket.blob(self._blob_name(write_io.path))
        await self._with_retry(functools.partial(_upload, blob, view), f"write {write_io.path}")

    async def _chunked_write(self, path: str, view: memoryview) -> None:
        """Parts of ``chunk_bytes`` uploaded at once, each under its own
        retry, composed into the object, and swept in every outcome."""
        name = self._blob_name(path)
        chunk = self._chunk_bytes
        n = (view.nbytes + chunk - 1) // chunk
        part_names = [f"{name}.part-{i:05d}" for i in range(n)]

        async def put(i: int) -> None:
            blob = self._bucket.blob(part_names[i])
            part = view[i * chunk : min((i + 1) * chunk, view.nbytes)]
            await self._with_retry(functools.partial(_upload, blob, part), f"write {path} [part {i}/{n}]")

        temps: list = []
        try:
            # every part settles before anything raises: a cancelled await
            # would leave its thread uploading past the sweep below
            results = await asyncio.gather(*(put(i) for i in range(n)), return_exceptions=True)
            errs = [r for r in results if isinstance(r, BaseException)]
            if errs:
                raise errs[0]
            temps = await self._compose_parts(path, name, part_names)
        finally:
            await self._sweep_blobs(part_names + temps)

    async def _compose_parts(self, path: str, name: str, part_names: list) -> list:
        """Compose ``part_names`` (non-empty) into ``name``, 32 at a time
        per level; returns the intermediate blobs for the caller to sweep."""
        if not part_names:
            raise ValueError(f"compose of {name}: no parts")
        sources, level = list(part_names), 0
        temps: list = []
        while sources != [name]:
            groups = [sources[j : j + _MAX_COMPOSE_COMPONENTS] for j in range(0, len(sources), _MAX_COMPOSE_COMPONENTS)]
            nxt = []
            for gi, grp in enumerate(groups):
                out = name if len(groups) == 1 else f"{name}.compose-{level}-{gi:05d}"
                dest = self._bucket.blob(out)
                await self._with_retry(
                    functools.partial(dest.compose, [self._bucket.blob(s) for s in grp]),
                    f"write {path} [compose L{level}.{gi}]",
                )
                nxt.append(out)
                if out != name:
                    temps.append(out)
            sources, level = nxt, level + 1
        return temps

    async def _sweep_blobs(self, blob_names) -> None:
        """Delete upload intermediates; a failed delete is logged, never
        raised over the write's own outcome."""
        for tmp in blob_names:
            try:
                await self._delete_blob(tmp)
            except Exception:  # noqa: BLE001
                logger.warning("failed to sweep upload intermediate %s", tmp, exc_info=True)

    async def begin_striped_write(self, path: str, total_size: int) -> "_GCSStripedWriteHandle":
        return _GCSStripedWriteHandle(self, path)

    # -------------------------------------------------------------- read

    async def read(self, read_io: ReadIO) -> None:
        name = self._blob_name(read_io.path)
        blob = self._bucket.blob(name)
        chunk = self._chunk_bytes
        if read_io.byte_range is None:
            # one ranged GET of the first chunk: a blob within it (the
            # common case) takes one request and no stat
            try:
                first = await self._with_retry(
                    functools.partial(blob.download_as_bytes, start=0, end=chunk - 1), f"read {read_io.path}",
                )
            except Exception as e:  # noqa: BLE001
                if _is_range_unsatisfiable(e):
                    read_io.buf = b""  # a zero-byte object
                    return
                raise
            if len(first) < chunk:
                read_io.buf = first
                return
            await self._with_retry(blob.reload, f"read {read_io.path} [stat]")
            start, end = 0, int(blob.size or 0)
            if end <= chunk:
                read_io.buf = first
                return
            # ``first`` may predate the stat's generation: fetch it all
            # again, pinned to that generation
            generation = getattr(blob, "generation", None)
        else:
            start, end = read_io.byte_range
            if end - start <= chunk:
                fn = functools.partial(blob.download_as_bytes, start=start, end=end - 1)
                read_io.buf = await self._with_retry(fn, f"read {read_io.path}")
                return
            await self._with_retry(blob.reload, f"read {read_io.path} [stat]")
            generation = getattr(blob, "generation", None)

        out = bytearray(end - start)

        async def get(lo: int, hi: int) -> None:
            kwargs = {"start": lo, "end": hi - 1}
            if generation is not None:
                kwargs["if_generation_match"] = generation
            fn = functools.partial(self._bucket.blob(name).download_as_bytes, **kwargs)
            data = await self._with_retry(fn, f"read {read_io.path} [{lo}:{hi}]")
            if len(data) != hi - lo:
                raise IOError(f"ranged read {read_io.path} [{lo}:{hi}] returned {len(data)} bytes")
            out[lo - start : hi - start] = data

        await asyncio.gather(*(get(lo, min(lo + chunk, end)) for lo in range(start, end, chunk)))
        read_io.buf = out

    async def link_from(self, base_url: str, path: str) -> None:
        """A server-side copy from the base snapshot (incremental takes)."""
        src_bucket_name, _, src_prefix = base_url.split("://", 1)[-1].partition("/")
        src_name = f"{src_prefix}/{path}" if src_prefix else path
        dst_name = self._blob_name(path)

        def copy() -> None:
            src_bucket = (
                self._bucket if src_bucket_name == self._bucket.name else self._client.bucket(src_bucket_name)
            )
            src_bucket.copy_blob(src_bucket.blob(src_name), self._bucket, dst_name)

        await self._with_retry(copy, f"read {src_name} (copy)")

    async def stat(self, path: str) -> int:
        blob_name = self._blob_name(path)

        def head() -> int:
            blob = self._bucket.blob(blob_name)
            blob.reload()
            return int(blob.size)

        return await self._with_retry(head, f"read {blob_name} (stat)")

    # ------------------------------------------------------------ delete

    async def _delete_blob(self, blob_name: str) -> None:
        await self._with_retry(self._bucket.blob(blob_name).delete, f"delete {blob_name}")

    async def delete(self, path: str) -> None:
        """Idempotent: a missing blob succeeds."""
        await self._delete_blob(self._blob_name(path))

    async def close(self) -> None:
        # no join: a call stuck in the client must not hold the caller
        self._executor.shutdown(wait=False)


class _GCSStripedWriteHandle(StripedWriteHandle):
    """The composite upload driven part by part by the stripe engine:
    each part its own blob, ``complete`` composes and sweeps, ``abort``
    sweeps the parts that landed."""

    def __init__(self, plugin: GCSStoragePlugin, path: str) -> None:
        self._plugin = plugin
        self._path = path
        self._name = plugin._blob_name(path)
        # part index -> blob name; filled on the plugin's one event loop
        self._parts: dict = {}
        self._finished = False

    async def write_part(self, index: int, offset: int, buf, want_digest: bool = False) -> None:
        view = memoryview(buf).cast("B")
        part_name = f"{self._name}.part-{index:05d}"
        blob = self._plugin._bucket.blob(part_name)

        def upload() -> None:
            failpoint("storage.gcs.part.write", path=self._path, part=index)
            _upload(blob, view)

        await self._plugin._with_retry(upload, f"write {self._path} [part {index}]")
        self._parts[index] = part_name

    async def complete(self) -> None:
        part_names = [self._parts[i] for i in sorted(self._parts)]
        if not part_names:
            # a zero-byte object: nothing to compose
            await self._plugin.write(WriteIO(path=self._path, buf=b""))
            self._finished = True
            return
        temps: list = []
        try:
            temps = await self._plugin._compose_parts(self._path, self._name, part_names)
        finally:
            await self._plugin._sweep_blobs(part_names + temps)
        self._finished = True

    async def abort(self) -> None:
        if self._finished:
            return
        self._finished = True
        await self._plugin._sweep_blobs([self._parts[i] for i in sorted(self._parts)])
