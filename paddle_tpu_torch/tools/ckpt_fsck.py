"""Offline checkpoint verifier of the port (counterpart of
tools/ckpt_fsck.py), for directories of distributed/elastic.py, which both
packages write.

Walks a checkpoint root (or one committed ``ckpt_<step>`` directory),
re-parses each manifest, recomputes its self-checksum and every payload's
sha256, and prints one JSON line a checkpoint, then a summary line.
Uncommitted ``.tmp.*`` directories are listed and never failed on.

Exit status: 0, every committed checkpoint verifies; 1, at least one is
corrupt; 2, nothing to verify.

    python -m paddle_tpu_torch.tools.ckpt_fsck /path/to/ckpts [--quiet]
    python -m paddle_tpu_torch.tools.ckpt_fsck /path/to/ckpts/ckpt_00000100
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from ..distributed import elastic


def fsck_one(path, quiet=False):
    row = {"path": path}
    try:
        manifest = elastic.verify_checkpoint(path)
        n_files = sum(len(e["shards"]) for kind in ("params", "opt", "buffers")
                      for e in (manifest.get(kind) or {}).values())
        zero = manifest.get("zero_opt")
        if zero is not None:
            n_files += len(zero["shards"])
        row.update(ok=True, step=manifest["step"], payload_files=n_files,
                   zero_opt=zero is not None)
    except elastic.CheckpointCorrupt as e:
        row.update(ok=False, error=str(e))
    if not quiet:
        print(json.dumps(row))
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("dir", help="checkpoint root, or one ckpt_<step> dir")
    ap.add_argument("--quiet", action="store_true",
                    help="summary line only, no per-checkpoint rows")
    args = ap.parse_args(argv)
    root = args.dir
    if os.path.isfile(os.path.join(root, elastic.MANIFEST)) or \
            os.path.basename(root).startswith(elastic.CKPT_PREFIX):
        rows, tmp = [fsck_one(root, args.quiet)], []
    else:
        rows = [fsck_one(p, args.quiet) for _step, p in elastic.list_checkpoints(root)]
        tmp = sorted(n for n in (os.listdir(root) if os.path.isdir(root) else [])
                     if n.startswith(elastic.TMP_PREFIX))
    bad = [r for r in rows if not r["ok"]]
    print(json.dumps({"checked": len(rows), "ok": len(rows) - len(bad),
                      "corrupt": len(bad), "uncommitted_tmp": tmp}))
    if bad:
        return 1
    return 0 if rows else 2


if __name__ == "__main__":
    sys.exit(main())
