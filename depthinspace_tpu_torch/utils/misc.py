"""Small host utilities, port of ``depthinspace_tpu/utils/misc.py`` (the
reference's co/utils.py: str2bool, git_hash)."""

from __future__ import annotations

import subprocess
from pathlib import Path

from .args import str2bool  # noqa: F401  (re-export)


def git_hash(cwd: str | Path | None = None) -> str | None:
    """The commit hash of the repository at ``cwd`` (or the current
    directory), None outside one or without git."""
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"],
                             cwd=str(cwd) if cwd else None,
                             capture_output=True, text=True, timeout=10)
        if out.returncode == 0:
            return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return None
