"""Audit checkpoint directories against the commit-marker contract of
``singa_tpu_torch.train.ckpt``, the port's counterpart of the JAX
package's ``tools/ckpt_fsck.py`` (``tools/lint/audit.fsck_ckpt_dir``).

    python -m singa_tpu_torch.tools.ckpt_fsck DIR [DIR ...]

The checks ARE the restore path's: ``AsyncCheckpointManager.verify``
for the marker, size and sha256, then ``utils.checkpoint``'s decode and
manifest checks (``load_arrays``, ``check_opt_manifest``), so the
auditor and a resume never disagree about what "intact" means.  A
committed file that fails them is an ERROR; a stray ``.tmp`` file (an
interrupted write) and an npz without a marker (uncommitted, ignored at
load) are warnings.

Exit code 0 = every committed checkpoint is intact (warnings allowed);
1 = at least one ERROR, printed one per line naming file and cause;
2 = usage error.
"""

from __future__ import annotations

import glob
import os
import sys
from typing import List, Optional, Tuple

from ..train import ckpt as train_ckpt
from ..utils import checkpoint

__all__ = ["fsck_dir", "main"]


def fsck_dir(directory: str) -> Tuple[List[str], List[str]]:
    """Audit one checkpoint directory; returns (errors, warnings)."""
    errors: List[str] = []
    warns: List[str] = []
    if not os.path.isdir(directory):
        return [f"{directory}: not a directory"], []
    for tmp in sorted(glob.glob(os.path.join(directory, "*.tmp"))):
        warns.append(f"{tmp}: stray temp file (interrupted write)")

    mgr = train_ckpt.AsyncCheckpointManager(directory)
    steps = mgr.steps()
    committed = {mgr.path(s) for s in steps}
    for marker in glob.glob(os.path.join(directory, "ckpt_*.npz"
                                         + train_ckpt.COMMIT_SUFFIX)):
        path = marker[:-len(train_ckpt.COMMIT_SUFFIX)]
        if path not in committed:
            # steps() couldn't parse the name, so restore can't see it
            errors.append(f"{marker}: unparsable marker name (invisible "
                          f"to restore)")
            committed.add(path)

    for step in steps:
        path = mgr.path(step)
        try:
            mgr.verify(step)
        except train_ckpt.CheckpointCorrupt as e:
            errors.append(str(e))
            continue
        # committed and byte-intact: the payload must also decode and
        # self-agree (array manifest vs members, opt moments vs slots)
        try:
            arrays, aux = checkpoint.load_arrays(path)
            checkpoint.check_opt_manifest(arrays, aux)
        except Exception as e:
            errors.append(f"{path}: committed but undecodable "
                          f"({type(e).__name__}: {e})")

    npzs = set(glob.glob(os.path.join(directory, "ckpt_*.npz")))
    for path in sorted(npzs - committed):
        warns.append(f"{path}: no commit marker (uncommitted — ignored "
                     f"at load)")
    return errors, warns


def main(argv: Optional[List[str]] = None) -> int:
    dirs = sys.argv[1:] if argv is None else list(argv)
    if not dirs or any(d.startswith("-") for d in dirs):
        print(__doc__, file=sys.stderr)
        return 2
    all_errors: List[str] = []
    for d in dirs:
        errors, warns = fsck_dir(os.path.abspath(d))
        for w in warns:
            print(f"ckpt_fsck: warning: {w}", file=sys.stderr)
        all_errors.extend(errors)
    if all_errors:
        for e in all_errors:
            print(f"ckpt_fsck: {e}", file=sys.stderr)
        print(f"ckpt_fsck: {len(all_errors)} error(s)", file=sys.stderr)
        return 1
    print("ckpt_fsck: all committed checkpoints intact")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
