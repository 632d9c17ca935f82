"""The bytes a kernel's calls need, counted from each call's own
arguments (each input byte read once, each output byte written once).

A reader ``metrics/<kernel>_roofline.py`` declares its kernel:
``ENTRY`` (``"module:attribute"``, the port's entry that launches it),
``TRACE_NAME`` (a substring of its launch's name in a device trace) and
``nbytes(*args, **kwargs)`` (the bytes of one call).  ``ByteRecorder``
wraps the entries of the readers a traced run reads; the program looks
each entry up on its module at call time, so the wrapper sees every
call.  A new kernel's roofline is one new reader file.
"""

from __future__ import annotations

import importlib
import threading
from typing import Any, Callable, Dict, Iterable, List, Tuple

DTYPE_BYTES = {
    "bfloat16": 2, "float16": 2, "float32": 4, "float64": 8, "int8": 1, "uint8": 1,
    "int16": 2, "int32": 4, "int64": 8, "bool": 1,
}


def nbytes(t: Any) -> int:
    return t.numel() * t.element_size()


def declares_kernel(reader: Any) -> bool:
    return all(hasattr(reader, k) for k in ("ENTRY", "TRACE_NAME", "nbytes"))


class ByteRecorder:
    """Within ``with``: the bytes each declared kernel's calls needed,
    keyed by its ``TRACE_NAME``."""

    def __init__(self, readers: Iterable[Any]) -> None:
        self.kernels = {(r.ENTRY, r.TRACE_NAME): r.nbytes for r in readers if declares_kernel(r)}
        self.bytes: Dict[str, int] = {trace: 0 for _, trace in self.kernels}
        self._lock = threading.Lock()
        self._saved: List[Tuple[Any, str, Callable]] = []

    def _wrap(self, trace: str, count: Callable[..., int], fn: Callable) -> Callable:
        def wrapper(*args, **kwargs):
            n = count(*args, **kwargs)
            with self._lock:
                self.bytes[trace] += n
            return fn(*args, **kwargs)

        return wrapper

    def __enter__(self) -> "ByteRecorder":
        for (entry, trace), count in self.kernels.items():
            module_name, attribute = entry.split(":")
            target = importlib.import_module(module_name)
            fn = getattr(target, attribute)
            self._saved.append((target, attribute, fn))
            setattr(target, attribute, self._wrap(trace, count, fn))
        return self

    def __exit__(self, *exc) -> None:
        for target, attribute, fn in reversed(self._saved):
            setattr(target, attribute, fn)
        self._saved = []
