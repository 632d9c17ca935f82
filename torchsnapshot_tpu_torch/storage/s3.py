"""S3 storage plugin (``s3://<bucket>/<prefix>``).

Counterpart of ``torchsnapshot_tpu/storage/s3.py``: the same objects and
keys (``<prefix>/<path>``), so either package restores the other's S3
snapshots.  The client is bound lazily in ``__init__``: ``boto3`` when it
is installed, else ``s3fs``, else a ``RuntimeError``; neither is imported
with this module.  The endpoint comes from the argument, else from the
``S3_ENDPOINT_URL`` knob (an S3-compatible store such as minio).

Every call runs under the shared retry policy with ``classify_s3``:
throttles (SlowDown), 5xx and connection or timeout errors retry with
backoff under the plugin's progress window; NoSuchKey / 404 is a
``FileNotFoundError`` for reads, stats and copies and a success for
deletes; anything else surfaces as itself.  Writes feed the ``s3``
breaker; failpoints ``storage.s3.{write,read,part.create,part.write,
part.complete}`` sit inside the retried calls.  Objects at the stripe
threshold go up as true multipart uploads (``_S3StripedWriteHandle``),
which an abort or a failed complete never leaves in progress.
"""

from __future__ import annotations

import functools
from concurrent.futures import ThreadPoolExecutor

from .. import knobs, obs
from ..io_types import ReadIO, StoragePlugin, StripedWriteHandle, WriteIO
from ..resilience import FATAL, MISSING, SUCCESS_NONE, classify_s3, get_breaker, lazy_shared_progress, retry_call
from ..resilience.failpoints import failpoint


@obs.instrument_storage("s3")
class S3StoragePlugin(StoragePlugin):
    def __init__(self, path: str, num_threads: int = 16, endpoint_url: str = None) -> None:
        self.bucket, _, self.prefix = path.partition("/")
        endpoint_url = endpoint_url or knobs.get_s3_endpoint_url()
        client_extra = {"endpoint_url": endpoint_url} if endpoint_url else {}
        try:
            import boto3

            self._backend = boto3.client("s3", **client_extra)
        except ImportError:
            try:
                import s3fs

                self._backend = s3fs.S3FileSystem(client_kwargs=client_extra or None)
            except ImportError:
                raise RuntimeError("s3:// support requires boto3 or s3fs; neither is installed") from None
        self._is_fs = not hasattr(self._backend, "put_object")
        self._executor = ThreadPoolExecutor(max_workers=num_threads, thread_name_prefix="tsnp-s3")

    def _key(self, path: str) -> str:
        return f"{self.prefix}/{path}" if self.prefix else path

    def _uri(self, key: str) -> str:
        return f"s3://{self.bucket}/{key}"

    async def _run(self, fn, op_name: str, on_missing: str = "raise", breaker=None):
        """One client call on the executor under the retry policy.
        ``on_missing``, what NoSuchKey / 404 means here: "fnf" (reads,
        stats, copies: ``FileNotFoundError``), "ok" (deletes, aborts:
        success) or "raise" (writes: fatal)."""

        def classify(e: BaseException) -> str:
            verdict = classify_s3(e)
            if verdict == MISSING and on_missing != "fnf":
                return SUCCESS_NONE if on_missing == "ok" else FATAL
            return verdict

        return await retry_call(
            fn, op_name=op_name, backend="s3", classify=classify,
            progress=lazy_shared_progress(self, "s3"), executor=self._executor, breaker=breaker,
        )

    async def write(self, write_io: WriteIO) -> None:
        # a read-only view of the staged buffer, not a copy held across
        # the retry loop (staged buffers are immutable once handed over)
        data = memoryview(write_io.buf).cast("B").toreadonly()
        key = self._key(write_io.path)
        if self._is_fs:
            full = f"{self.bucket}/{key}"

            def put() -> None:
                failpoint("storage.s3.write", path=write_io.path)
                # s3fs takes bytes: the copy lives for one attempt only
                self._backend.pipe(full, bytes(data))
        else:

            def put() -> None:
                failpoint("storage.s3.write", path=write_io.path)
                self._backend.put_object(Bucket=self.bucket, Key=key, Body=data)

        await self._run(put, f"write {self._uri(key)}", breaker=get_breaker("s3"))

    @property
    def supports_striped_write(self) -> bool:
        # multipart needs the boto3 verbs; over s3fs writes stay whole
        return not self._is_fs

    async def begin_striped_write(self, path: str, total_size: int) -> "_S3StripedWriteHandle":
        key = self._key(path)

        def create() -> str:
            failpoint("storage.s3.part.create", path=path)
            return self._backend.create_multipart_upload(Bucket=self.bucket, Key=key)["UploadId"]

        upload_id = await self._run(create, f"write {self._uri(key)} [create-multipart]", breaker=get_breaker("s3"))
        return _S3StripedWriteHandle(self, path, key, upload_id)

    async def read(self, read_io: ReadIO) -> None:
        key = self._key(read_io.path)
        if self._is_fs:
            full = f"{self.bucket}/{key}"
            if read_io.byte_range is None:
                fetch = functools.partial(self._backend.cat_file, full)
            else:
                start, end = read_io.byte_range
                fetch = functools.partial(self._backend.cat_file, full, start=start, end=end)

            def get():
                failpoint("storage.s3.read", path=read_io.path)
                return fetch()
        else:
            kwargs = {"Bucket": self.bucket, "Key": key}
            if read_io.byte_range is not None:
                start, end = read_io.byte_range
                kwargs["Range"] = f"bytes={start}-{end - 1}"  # inclusive end

            def get() -> bytes:
                failpoint("storage.s3.read", path=read_io.path)
                # the body belongs to this attempt: a connection dropped
                # mid-stream retries the whole GET
                return self._backend.get_object(**kwargs)["Body"].read()

        read_io.buf = await self._run(get, f"read {self._uri(key)}", on_missing="fnf")

    async def link_from(self, base_url: str, path: str) -> None:
        """A server-side copy from the base snapshot (incremental takes);
        a missing base object raises ``FileNotFoundError`` and the caller
        writes the bytes instead."""
        src_bucket, _, src_prefix = base_url.split("://", 1)[-1].partition("/")
        src_key = f"{src_prefix}/{path}" if src_prefix else path
        if self._is_fs:
            copy = functools.partial(self._backend.copy, f"{src_bucket}/{src_key}", f"{self.bucket}/{self._key(path)}")
        else:
            copy = functools.partial(
                self._backend.copy_object, Bucket=self.bucket, Key=self._key(path),
                CopySource={"Bucket": src_bucket, "Key": src_key},
            )
        await self._run(copy, f"copy s3://{src_bucket}/{src_key}", on_missing="fnf")

    async def stat(self, path: str) -> int:
        key = self._key(path)
        if self._is_fs:

            def head() -> int:
                return int(self._backend.info(f"{self.bucket}/{key}")["size"])
        else:

            def head() -> int:
                return int(self._backend.head_object(Bucket=self.bucket, Key=key)["ContentLength"])

        return await self._run(head, f"stat {self._uri(key)}", on_missing="fnf")

    async def delete(self, path: str) -> None:
        """Idempotent, as S3's own DeleteObject: a missing key succeeds."""
        key = self._key(path)
        if self._is_fs:
            # s3fs raises FileNotFoundError itself, which the retry engine
            # passes through: map it here
            def rm() -> None:
                try:
                    self._backend.rm_file(f"{self.bucket}/{key}")
                except FileNotFoundError:
                    pass
        else:
            rm = functools.partial(self._backend.delete_object, Bucket=self.bucket, Key=key)
        await self._run(rm, f"delete {self._uri(key)}", on_missing="ok")

    async def close(self) -> None:
        # no join: a call stuck in the client must not hold the caller
        self._executor.shutdown(wait=False)


class _S3StripedWriteHandle(StripedWriteHandle):
    """A multipart upload: CreateMultipartUpload, concurrent UploadPart
    (1-based part numbers), CompleteMultipartUpload with the ETags.  A
    failure aborts it (S3 keeps an uncompleted upload's parts, and bills
    them, until it is aborted).  Each part retries on its own and feeds
    the ``s3`` breaker."""

    # S3's EntityTooSmall floor for every part but the last: an encoded
    # part below it is stored raw
    min_part_bytes: int = 5 << 20

    def __init__(self, plugin: S3StoragePlugin, path: str, key: str, upload_id: str) -> None:
        self._plugin = plugin
        self._path = path
        self._key = key
        self._upload_id = upload_id
        # bytes sent: the object's size once complete (encoded parts make
        # it smaller than the raw total), what a lost response is checked by
        self._bytes_uploaded = 0
        # part number -> ETag; parts complete on the plugin's one event loop
        self._etags: dict = {}
        self._finished = False

    def _op(self, what: str) -> str:
        return f"write {self._plugin._uri(self._key)} [{what}]"

    async def write_part(self, index: int, offset: int, buf, want_digest: bool = False) -> None:
        part_number = index + 1
        view = memoryview(buf).cast("B").toreadonly()
        p = self._plugin

        def upload() -> str:
            failpoint("storage.s3.part.write", path=self._path, part=index)
            return p._backend.upload_part(
                Bucket=p.bucket, Key=self._key, PartNumber=part_number, UploadId=self._upload_id, Body=view,
            )["ETag"]

        self._etags[part_number] = await p._run(upload, self._op(f"part {part_number}"), breaker=get_breaker("s3"))
        self._bytes_uploaded += view.nbytes

    async def complete(self) -> None:
        parts = [{"PartNumber": n, "ETag": self._etags[n]} for n in sorted(self._etags)]
        p = self._plugin

        def finish() -> None:
            failpoint("storage.s3.part.complete", path=self._path)
            p._backend.complete_multipart_upload(
                Bucket=p.bucket, Key=self._key, UploadId=self._upload_id, MultipartUpload={"Parts": parts},
            )

        try:
            await p._run(finish, self._op("complete-multipart"), breaker=get_breaker("s3"))
        except Exception as e:
            # a complete that committed but lost its response makes the
            # retry see NoSuchUpload: an object of the uploaded size means
            # the complete won
            try:
                published = await p.stat(self._path) == self._bytes_uploaded
            except Exception as stat_err:  # noqa: BLE001 — the original error wins
                obs.swallowed_exception("storage.s3.complete_verify", stat_err)
                published = False
            if published:
                self._finished = True
                return
            await self.abort()
            raise e
        except BaseException:
            await self.abort()
            raise
        self._finished = True

    async def abort(self) -> None:
        if self._finished:
            return
        self._finished = True
        p = self._plugin

        def do_abort() -> None:
            p._backend.abort_multipart_upload(Bucket=p.bucket, Key=self._key, UploadId=self._upload_id)

        # an upload already gone is success; any other error is logged and
        # swallowed, never masking the failure that caused the abort
        try:
            await p._run(do_abort, f"abort {p._uri(self._key)} [multipart]", on_missing="ok")
        except Exception as e:  # noqa: BLE001
            obs.swallowed_exception("storage.s3.abort_multipart", e)
