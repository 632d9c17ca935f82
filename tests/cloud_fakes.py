"""In-process object stores for the ``s3://`` and ``gs://`` plugins where
neither client library nor a network exists: the card's machine, in
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.  Imports neither JAX
nor the JAX package.

``S3Fake`` is a ``boto3`` S3 client's surface the plugin calls; every
call and response is checked against the vendored service model
(``s3_service_model.py``) and every error code against its error set,
as the JAX suite's ``FakeBoto3Client`` does, but it keeps one copy of
each object and hands ranged GETs out as views, so a state of several
GB fits.  ``GCSFake`` holds buckets of blobs with the
``google-cloud-storage`` calls the plugin makes (ranged downloads pinned
to a generation, ``compose`` of at most 32 sources, blob copies, 404 and
416).  ``install_s3`` / ``install_gcs`` put a fake behind the ``boto3``
or ``google.cloud.storage`` module name until the returned callable
undoes it.  Both count their calls by operation (``ops``) and record the
length of every ranged GET (``ranges``: (key, length)).
"""

from __future__ import annotations

import collections
import sys
import threading
import types

import s3_service_model as model


class S3Error(Exception):
    """ClientError-shaped: ``response["Error"]["Code"]``, a modeled code."""

    def __init__(self, python_name, code, key):
        model.validate_error(python_name, code)
        super().__init__(f"{code}: {key}")
        self.response = {"Error": {"Code": code}}


class _Body:
    """StreamingBody's surface: read, close, not seekable.  ``read``
    returns a view of the stored object, never a copy."""

    def __init__(self, view):
        self._view = view
        self._pos = 0

    def read(self, amt=None):
        end = len(self._view) if amt is None else min(len(self._view), self._pos + amt)
        out = self._view[self._pos:end]
        self._pos = end
        return out

    def close(self):
        self._view = memoryview(b"")


class _Counted:
    def __init__(self):
        self._lock = threading.Lock()
        self.ops = collections.Counter()
        self.ranges = []

    def _count(self, op):
        with self._lock:
            self.ops[op] += 1


class S3Fake(_Counted):
    def __init__(self):
        super().__init__()
        self.objects = {}  # (bucket, key) -> bytes
        self.multipart_uploads = {}  # upload id -> {"bucket", "key", "parts": {n: (etag, bytes)}}
        self._seq = 0

    def _call(self, name, kw):
        model.validate_call(name, kw)
        self._count(name)

    def _respond(self, name, kw, resp):
        model.validate_response(name, kw, resp)
        return resp

    @staticmethod
    def _etag(data):
        # unique while the object lives, with no pass over its bytes (a
        # digest here would cost the fake more than the plugin's own work)
        return '"%x-%d"' % (id(data), len(data))

    @staticmethod
    def _bytes(body):
        return body.encode() if isinstance(body, str) else bytes(body)

    def put_object(self, **kw):
        self._call("put_object", kw)
        data = self._bytes(kw.get("Body", b""))
        self.objects[(kw["Bucket"], kw["Key"])] = data
        return self._respond("put_object", kw, {"ETag": self._etag(data)})

    def get_object(self, **kw):
        self._call("get_object", kw)
        key = (kw["Bucket"], kw["Key"])
        if key not in self.objects:
            raise S3Error("get_object", "NoSuchKey", kw["Key"])
        stored = self.objects[key]
        resp = {"ETag": self._etag(stored)}
        data = memoryview(stored)
        rng = kw.get("Range")
        if rng is not None:
            lo, hi = (int(x) for x in rng[len("bytes="):].split("-"))
            if lo >= len(data):
                raise S3Error("get_object", "InvalidRange", kw["Key"])
            hi = min(hi, len(data) - 1)
            resp["ContentRange"] = f"bytes {lo}-{hi}/{len(data)}"
            data = data[lo:hi + 1]
            with self._lock:
                self.ranges.append((kw["Key"], len(data)))
        resp["Body"] = _Body(data)
        resp["ContentLength"] = len(data)
        return self._respond("get_object", kw, resp)

    def head_object(self, **kw):
        self._call("head_object", kw)
        key = (kw["Bucket"], kw["Key"])
        if key not in self.objects:
            raise S3Error("head_object", "404", kw["Key"])
        return self._respond("head_object", kw, {"ContentLength": len(self.objects[key])})

    def copy_object(self, **kw):
        self._call("copy_object", kw)
        src = (kw["CopySource"]["Bucket"], kw["CopySource"]["Key"])
        if src not in self.objects:
            raise S3Error("copy_object", "NoSuchKey", src[1])
        self.objects[(kw["Bucket"], kw["Key"])] = self.objects[src]
        return self._respond("copy_object", kw, {"CopyObjectResult": {"ETag": self._etag(self.objects[src])}})

    def delete_object(self, **kw):
        self._call("delete_object", kw)
        self.objects.pop((kw["Bucket"], kw["Key"]), None)
        return self._respond("delete_object", kw, {})

    def create_multipart_upload(self, **kw):
        self._call("create_multipart_upload", kw)
        with self._lock:
            self._seq += 1
            upload_id = f"upload-{self._seq:05d}"
        self.multipart_uploads[upload_id] = {"bucket": kw["Bucket"], "key": kw["Key"], "parts": {}}
        return self._respond("create_multipart_upload", kw,
                             {"Bucket": kw["Bucket"], "Key": kw["Key"], "UploadId": upload_id})

    def upload_part(self, **kw):
        self._call("upload_part", kw)
        up = self.multipart_uploads.get(kw["UploadId"])
        if up is None:
            raise S3Error("upload_part", "NoSuchUpload", kw["Key"])
        data = self._bytes(kw.get("Body", b""))
        etag = self._etag(data)
        up["parts"][kw["PartNumber"]] = (etag, data)
        return self._respond("upload_part", kw, {"ETag": etag})

    def complete_multipart_upload(self, **kw):
        self._call("complete_multipart_upload", kw)
        up = self.multipart_uploads.get(kw["UploadId"])
        if up is None:
            raise S3Error("complete_multipart_upload", "NoSuchUpload", kw["Key"])
        parts = kw["MultipartUpload"]["Parts"]
        numbers = [p["PartNumber"] for p in parts]
        if not parts or numbers != sorted(numbers):
            raise S3Error("complete_multipart_upload", "InvalidPartOrder", kw["Key"])
        if any(up["parts"].get(p["PartNumber"], (None,))[0] != p["ETag"] for p in parts):
            raise S3Error("complete_multipart_upload", "InvalidPart", kw["Key"])
        # S3's EntityTooSmall: every part but the last at least 5 MiB
        if any(len(up["parts"][n][1]) < (5 << 20) for n in numbers[:-1]):
            raise ValueError(f"EntityTooSmall: a part of {kw['Key']} below 5 MiB")
        blob = b"".join(up["parts"][n][1] for n in numbers)
        del self.multipart_uploads[kw["UploadId"]]
        self.objects[(kw["Bucket"], kw["Key"])] = blob
        return self._respond("complete_multipart_upload", kw,
                             {"Bucket": kw["Bucket"], "Key": kw["Key"], "ETag": self._etag(blob)})

    def abort_multipart_upload(self, **kw):
        self._call("abort_multipart_upload", kw)
        if self.multipart_uploads.pop(kw["UploadId"], None) is None:
            raise S3Error("abort_multipart_upload", "NoSuchUpload", kw["Key"])
        return self._respond("abort_multipart_upload", kw, {})


class GCSError(Exception):
    def __init__(self, code, name):
        super().__init__(f"{code}: {name}")
        self.code = code


class _Blob:
    def __init__(self, bucket, name):
        self.bucket = bucket
        self.name = name
        self.size = None
        self.generation = None

    def upload_from_file(self, stream, size, rewind=True, checksum=None):
        data = stream.read()
        if len(data) != size:
            raise ValueError(f"upload of {self.name}: {len(data)} bytes, size {size}")
        self.bucket._put(self.name, data, "upload")

    def download_as_bytes(self, start=None, end=None, if_generation_match=None):
        fake = self.bucket.fake
        fake._count("download")
        with fake._lock:
            data, gen = self.bucket.data.get(self.name, (None, None))
        if data is None:
            raise GCSError(404, self.name)
        if if_generation_match is not None and if_generation_match != gen:
            raise GCSError(412, self.name)
        if start is None:
            return data
        if start >= len(data):
            raise GCSError(416, self.name)
        out = memoryview(data)[start:end + 1]  # GCS's end is inclusive
        with fake._lock:
            fake.ranges.append((self.name, len(out)))
        return out

    def reload(self):
        self.bucket.fake._count("reload")
        if self.name not in self.bucket.data:
            raise GCSError(404, self.name)
        data, self.generation = self.bucket.data[self.name]
        self.size = len(data)

    def compose(self, sources):
        if len(sources) > 32:
            raise ValueError(f"compose of {len(sources)} sources (limit 32)")
        self.bucket._put(self.name, b"".join(self.bucket.data[s.name][0] for s in sources), "compose")

    def delete(self):
        self.bucket.fake._count("delete")
        if self.bucket.data.pop(self.name, None) is None:
            raise GCSError(404, self.name)


class _Bucket:
    def __init__(self, fake, name):
        self.fake = fake
        self.name = name
        self.data = {}  # blob name -> (bytes, generation)

    def _put(self, name, data, op):
        self.fake._count(op)
        with self.fake._lock:
            gen = self.data.get(name, (None, 0))[1] + 1
            self.data[name] = (data, gen)

    def blob(self, name):
        return _Blob(self, name)

    def copy_blob(self, src_blob, dst_bucket, new_name):
        if src_blob.name not in self.data:
            raise GCSError(404, src_blob.name)
        dst_bucket._put(new_name, self.data[src_blob.name][0], "copy")


class GCSFake(_Counted):
    def __init__(self):
        super().__init__()
        self.buckets = {}

    def bucket(self, name):
        with self._lock:
            if name not in self.buckets:
                self.buckets[name] = _Bucket(self, name)
            return self.buckets[name]


def _install(names_to_modules):
    saved = {name: sys.modules.get(name, None) for name in names_to_modules}

    for name, mod in names_to_modules.items():
        sys.modules[name] = mod

    def uninstall():
        for name, mod in saved.items():
            if mod is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = mod

    return uninstall


def install_s3(fake):
    """``boto3.client("s3", ...)`` returns ``fake`` until the returned
    callable is called."""
    return _install({"boto3": types.SimpleNamespace(client=lambda service, **kw: fake)})


def install_gcs(fake):
    """``google.cloud.storage.Client()`` buckets live in ``fake`` until the
    returned callable is called."""
    storage = types.ModuleType("google.cloud.storage")
    storage.Client = lambda *a, **kw: fake
    mods = {"google.cloud.storage": storage}
    try:
        import google.cloud as cloud
    except ImportError:
        google = types.ModuleType("google")
        cloud = types.ModuleType("google.cloud")
        google.cloud = cloud
        mods.update({"google": google, "google.cloud": cloud})
    had = getattr(cloud, "storage", None)
    cloud.storage = storage
    undo = _install(mods)

    def uninstall():
        undo()
        if had is None:
            del cloud.storage
        else:
            cloud.storage = had

    return uninstall
