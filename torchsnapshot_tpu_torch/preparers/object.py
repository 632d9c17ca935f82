"""Object preparer: the path for arbitrary Python objects.

Counterpart of ``torchsnapshot_tpu/preparers/object.py``: payloads go
through the safe msgpack codec first, pickle only behind the
ALLOW_PICKLE_OBJECTS knob (see serialization.py).
"""

from __future__ import annotations

from concurrent.futures import Executor
from typing import Any, List, Optional, Tuple

from ..io_types import BufferConsumer, BufferStager, Future, ReadReq, WriteReq, run_on
from ..manifest import ObjectEntry
from ..serialization import deserialize_object, serialize_object


class ObjectBufferStager(BufferStager):
    """Objects are serialized at plan time: their size is unknown until
    encoded, and object payloads are small."""

    def __init__(self, payload: bytes) -> None:
        self.payload = payload

    async def stage_buffer(self, executor: Optional[Executor] = None) -> bytes:
        return self.payload

    def get_staging_cost_bytes(self) -> int:
        return len(self.payload)


class ObjectBufferConsumer(BufferConsumer):
    def __init__(self, entry: ObjectEntry, fut: Future) -> None:
        self.entry = entry
        self.fut = fut

    async def consume_buffer(
        self, buf: Any, executor: Optional[Executor] = None
    ) -> None:
        self.fut.set(await run_on(executor, deserialize_object, buf, self.entry.serializer))

    def get_consuming_cost_bytes(self) -> int:
        return 1  # size unknown before the read; treat as negligible


class ObjectIOPreparer:
    @staticmethod
    def prepare_write(
        obj: Any, location: str, replicated: bool
    ) -> Tuple[ObjectEntry, List[WriteReq]]:
        payload, serializer = serialize_object(obj)
        entry = ObjectEntry(
            location=location, serializer=serializer, replicated=replicated
        )
        return entry, [
            WriteReq(
                path=location,
                buffer_stager=ObjectBufferStager(payload),
                checksum_sinks=[
                    (lambda c, e=entry: setattr(e, "crc32", c), None)
                ],
            )
        ]

    @staticmethod
    def prepare_read(entry: ObjectEntry) -> Tuple[List[ReadReq], Future]:
        fut: Future = Future()
        return (
            [
                ReadReq(
                    path=entry.location,
                    byte_range=list(entry.byte_range) if entry.byte_range else None,
                    buffer_consumer=ObjectBufferConsumer(entry, fut),
                    expected_crc32=entry.crc32,
                )
            ],
            fut,
        )
