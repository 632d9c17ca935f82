"""Self-checksum trailer shared by ``.snapshot_metadata`` and
``.snapshot_obsrecord``.

One construction, one set of subtle rules, two files: the serialized
document gets a trailing comment line carrying the crc32 of everything
before it.  The marker starts with ``\\n#`` — ``json.dumps`` escapes
newlines inside strings, so the raw byte sequence can never occur in
the JSON body, and a plain-YAML/JSON reader treats the trailer as a
comment / trailing garbage rather than data.

Read-side rules (the every-bit-flip-fails property):

- the trailer hex must be EXACTLY 8 lowercase hex digits (the writer's
  ``%08x``) — a sloppy ``int(x, 16)`` would accept case-flipped,
  ``0x``-prefixed, signed or ``_``-separated variants;
- a file whose final line is trailer-SHAPED (``#...``) but fails the
  exact-marker match is corruption inside the marker bytes, not a
  legacy trailer-less file — it must be rejected, never silently
  downgraded to an unverified parse.
"""

from __future__ import annotations

import re
import zlib
from typing import Tuple

_HEX8 = re.compile(r"[0-9a-f]{8}")


def append_crc_trailer(body: str, marker: str) -> str:
    """``body`` + the marker + the crc32 of body, ``%08x``."""
    return f"{body}{marker}{zlib.crc32(body.encode()):08x}"


def strip_crc_trailer(
    s: str, marker: str, label: str, fname: str
) -> Tuple[str, bool]:
    """Verify and remove the trailer; returns ``(body, had_trailer)``.

    Raises ``RuntimeError`` on checksum mismatch, unparseable trailer
    hex, or a trailer-shaped final line that fails the marker match;
    ``(s, False)`` for a genuinely trailer-less (legacy) document.
    ``label``/``fname`` only shape the error message (e.g.
    ``"metadata"`` / ``".snapshot_metadata"``)."""
    body, m, trailer = s.rpartition(marker)
    if m:
        t = trailer.strip()
        recorded = int(t, 16) if _HEX8.fullmatch(t) else None
        actual = zlib.crc32(body.encode())
        if recorded != actual:
            shown = (
                f"recorded {recorded:#010x}"
                if recorded is not None
                else f"unparseable trailer {t[:24]!r}"
            )
            raise RuntimeError(
                f"{label} checksum mismatch: {fname} is "
                f"corrupt ({shown}, actual {actual:#010x})"
            )
        return body, True
    last_line = s[s.rfind("\n") + 1:].strip()
    if last_line.startswith("#"):
        raise RuntimeError(
            f"{label} checksum mismatch: final line is "
            "trailer-shaped but does not match the expected "
            f"marker — corrupt {fname} trailer"
        )
    return s, False
