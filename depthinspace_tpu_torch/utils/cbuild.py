"""Host libraries built from C++ sources of the repository at first use
(the renderer, the zstd decoder): ``g++`` compiles a source into
``<build_root>/<hash>/<name>``, the hash covering the compiler, the flags
and the source, so an edited source is rebuilt. Each process compiles into
a file of its own and renames it into place, so processes started together
do not collide. A failed build raises with the compiler's output."""

from __future__ import annotations

import hashlib
import os
import subprocess
import time
from pathlib import Path

CXX = "g++"


def library_path(source: Path, build_root: Path, name: str,
                 flags: tuple) -> Path:
    digest = hashlib.sha256(" ".join((CXX,) + tuple(flags)).encode())
    digest.update(Path(source).read_bytes())
    return Path(build_root) / digest.hexdigest()[:16] / name


def build_library(source: Path, build_root: Path, name: str,
                  flags: tuple) -> tuple[Path, float]:
    """Compile ``source`` unless it is already built. Returns (path,
    seconds spent compiling; 0.0 when it was built before)."""
    so = library_path(source, build_root, name, flags)
    if so.exists():
        return so, 0.0
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [CXX, *flags, "-o", str(tmp), str(source)]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"{CXX} not found: {e}") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{CXX} failed ({res.returncode}): {' '.join(cmd)}"
                           f"\n{res.stdout}{res.stderr}")
    seconds = time.perf_counter() - t0
    os.replace(tmp, so)
    return so, seconds
