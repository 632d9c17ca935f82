"""Operator CLI: inspect, audit and manage snapshots from a shell.

    python -m torchsnapshot_tpu_torch ls        <snapshot-path>
    python -m torchsnapshot_tpu_torch manifest  <snapshot-path>
    python -m torchsnapshot_tpu_torch verify    <snapshot-path> [--deep] [--rank N]
    python -m torchsnapshot_tpu_torch steps     <manager-root>
    python -m torchsnapshot_tpu_torch delete    <snapshot-path> --yes

Counterpart of ``python -m torchsnapshot_tpu``: these five commands
print what the JAX package's print, field for field, and exit with the
same codes (non-zero when a verify fails or a delete is refused).  The
others (``stats``, ``doctor``, ``trace``, ``tiers``, ``convert``,
``lint``, ``cas``) are not ported yet: each exits 1 naming its ROADMAP
queue A item.
"""

from __future__ import annotations

import argparse
import json
import sys

# the JAX CLI's commands this one lacks, with the queue A item that ports them
_NOT_PORTED = {
    "stats": "2", "doctor": "2", "trace": "2", "tiers": "3.5", "convert": "4", "lint": "8",
    "cas": "3.3",
}


def _human(n: float) -> str:
    if n < 1024:
        return f"{int(n)}B"
    for unit in ("KB", "MB", "GB", "TB"):
        n /= 1024.0
        if n < 1024 or unit == "TB":
            return f"{n:.1f}{unit}"
    raise AssertionError("unreachable")


def _cmd_ls(args) -> int:
    from .manifest import is_container_entry
    from .serialization import serialized_size_bytes
    from .snapshot import Snapshot

    rows = []
    for lpath, e in sorted(Snapshot(args.path).get_manifest().items()):
        if is_container_entry(e):
            continue
        detail, nbytes = "", 0
        shape, dtype = getattr(e, "shape", None), getattr(e, "dtype", None)
        if shape is not None and dtype is not None:
            detail = f"{dtype}{list(shape)}"
            nbytes = serialized_size_bytes(shape, dtype)
        rows.append((lpath, e.type, detail, nbytes))
    width = max((len(r[0]) for r in rows), default=10)
    for lpath, kind, detail, nbytes in rows:
        size = _human(nbytes) if nbytes else ""
        print(f"{lpath:<{width}}  {kind:<12} {detail:<24} {size}")
    print(f"{len(rows)} entries")
    return 0


def _cmd_manifest(args) -> int:
    from .snapshot import Snapshot

    print(json.dumps(json.loads(Snapshot(args.path).metadata.to_json()), indent=2))
    return 0


def _cmd_verify(args) -> int:
    from .snapshot import Snapshot
    from .verify import verify_snapshot

    res = verify_snapshot(Snapshot(args.path), deep=args.deep, rank=args.rank)
    print(str(res))
    return 0 if res.ok else 1


def _cmd_steps(args) -> int:
    from .manager import SnapshotManager

    mgr = SnapshotManager(args.root)
    steps = mgr.steps()
    for step in steps:
        print(f"{step}\t{mgr.path_for_step(step)}")
    if not steps:
        print("(no committed snapshots)", file=sys.stderr)
    return 0


def _cmd_delete(args) -> int:
    from .manager import delete_snapshot

    if not args.yes:
        print("refusing to delete without --yes", file=sys.stderr)
        return 2
    delete_snapshot(args.path)
    print(f"deleted {args.path}")
    return 0


def _not_ported(cmd: str) -> int:
    print(
        f"error: `{cmd}` is not ported yet (ROADMAP queue A item {_NOT_PORTED[cmd]}); "
        "run it with `python -m torchsnapshot_tpu`",
        file=sys.stderr,
    )
    return 1


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in _NOT_PORTED:
        # before the parser: their arguments are not parsed at all
        return _not_ported(argv[0])
    parser = argparse.ArgumentParser(prog="python -m torchsnapshot_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("ls", help="list a snapshot's logical entries")
    p.add_argument("path")
    p.set_defaults(fn=_cmd_ls)

    p = sub.add_parser("manifest", help="dump snapshot metadata as JSON")
    p.add_argument("path")
    p.set_defaults(fn=_cmd_manifest)

    p = sub.add_parser("verify", help="integrity audit (exit 1 on failure)")
    p.add_argument("path")
    p.add_argument("--deep", action="store_true",
                   help="re-read payloads against recorded checksums")
    p.add_argument("--rank", type=int, default=0)
    p.set_defaults(fn=_cmd_verify)

    p = sub.add_parser("steps", help="list a manager root's committed steps")
    p.add_argument("root")
    p.set_defaults(fn=_cmd_steps)

    p = sub.add_parser("delete", help="delete one snapshot (metadata-first)")
    p.add_argument("path")
    p.add_argument("--yes", action="store_true")
    p.set_defaults(fn=_cmd_delete)

    for name, item in _NOT_PORTED.items():
        # listed for --help; main() answers them before parsing
        sub.add_parser(name, help=f"not ported yet (ROADMAP queue A item {item})")

    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except (FileNotFoundError, RuntimeError, ValueError) as e:
        # a missing, corrupt or aborted snapshot prints one clean line
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
