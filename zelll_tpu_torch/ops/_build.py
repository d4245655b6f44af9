"""Builds the port's native code at first use, from the sources in the
package, into the git-ignored ``build/`` directory at the root of the
checkout (never next to the source).

Each library is named after a hash of its source, the headers it includes
(`sources`) and its compiler command, so an edited source, header or flag
builds anew. A build writes to a temporary file and renames it into place,
so concurrent processes cannot see half a file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Callable

BUILD_DIR = Path(__file__).resolve().parents[2] / "build"

# nvcc for Hopper: sm_90a. No --use_fast_math: the kernels keep IEEE
# division. --fmad=false keeps every multiply and add rounded on its own,
# as the plain PyTorch versions round them, so pair masks agree bitwise.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Portable x86-64 code: a build directory may outlive the host that made it.
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


def nvcc() -> str:
    """Path of the CUDA compiler: on PATH, under CUDA_HOME, or in the
    toolkit's default prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return str(path)


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def sources(src: Path) -> list[Path]:
    """``src`` and every file it includes with ``#include "..."``, found
    beside the including file, recursively, each once, in a fixed order."""
    found, todo = [], [src]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        for name in _INCLUDE.findall(path.read_bytes()):
            inc = path.parent / name.decode()
            if inc.exists():
                todo.append(inc)
    return found


def build_shared(src: Path, compiler: str, flags, name: str) -> tuple[Path, str]:
    """Compile ``src`` into ``build/<name>-<hash>.so`` unless that file
    exists; the hash covers the source, the headers it includes (`sources`)
    and the flags. Returns the library's path and the compiler's output
    from the build (kept beside the library in a ``.log`` file)."""
    argv = [compiler, *flags]
    digest = hashlib.sha256(
        b"".join(path.read_bytes() for path in sources(src))
        + "\0".join(argv[1:]).encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"{name}-{digest}.so"
    log = out.with_suffix(".log")
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run([*argv, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"building {src.name} failed ({' '.join(argv)}):\n{proc.stderr}"
            )
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    return out, log.read_text() if log.exists() else ""


def kernel_loader(src: Path, name: str, bind: Callable[[ctypes.CDLL], None]):
    """A loader for the CUDA library built from ``src``: the first call
    builds it with nvcc (`build_shared`), loads it with ctypes and lets
    ``bind`` declare its C functions; later calls return the same library.
    The loader keeps the library as ``.lib`` and its build log (ptxas'
    registers and spills) as ``.log``."""

    def load() -> ctypes.CDLL:
        if load.lib is None:
            path, log = build_shared(src, nvcc(), NVCC_FLAGS, name)
            lib = ctypes.CDLL(str(path))
            bind(lib)
            load.lib, load.log = lib, log
        return load.lib

    load.lib = None
    load.log = ""
    return load
