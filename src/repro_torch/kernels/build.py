"""Build the port's CUDA sources (`kernels/csrc/*.cu`) at first use.

Each source compiles with `nvcc` into a shared library with a plain C
interface (loaded with `ctypes` by its wrapper module) under
`build/repro_torch_kernels/` at the root of the checkout. The library's name
carries a hash of the source, of every header under `csrc/` that it
includes (`#include "name.cuh"`, followed into headers), and of the flags,
so an edited source or header builds anew and an unchanged one is loaded
from disk. `build()` starts one `nvcc` per missing library, all at once,
and waits for them together. The compiler's resource report (`-Xptxas -v`:
registers, shared memory and spills per kernel) is kept beside each
library as `<name>-<hash>.log`.

Nothing is compiled on import: the CPU tests import every module on a
machine without `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
import time

__all__ = ["SOURCES", "BUILD_DIR", "build", "library_path", "load"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
#: `<checkout>/build/repro_torch_kernels` (src/repro_torch/kernels -> root)
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
#: every CUDA source of the port, by stem
SOURCES = ("gossip_mix", "compress_mix", "flash_attention",
           "flash_attention_sm90", "ssd_scan", "selective_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}
#: one first load at a time in a process: two threads that built the same
#: library at once would write the same temporary file
_LOAD_LOCK = threading.Lock()
_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.MULTILINE)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       f"{cuda_home}/bin); the port's CUDA kernels are "
                       "built at first use on a machine with the CUDA "
                       "toolkit")


def _inputs(name: str) -> list[pathlib.Path]:
    """Source `name` and every header under `CSRC` it includes, directly or
    through another header, in a fixed order."""
    found, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in found:
            continue
        found.append(path)
        for include in _INCLUDE.findall(path.read_bytes()):
            header = CSRC / include.decode()
            if header.is_file():
                todo.append(header)
    return [found[0], *sorted(found[1:])]


def library_path(name: str) -> pathlib.Path:
    """Where the library of source `name` lives once built: named by a hash
    of the source, its headers under `CSRC` and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _inputs(name):
        digest.update(f"\0{path.name}\0".encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Compile every source in `names` whose library is missing, all `nvcc`
    processes started together. Returns the wall seconds each build took
    (0.0 for a library already on disk). Raises `RuntimeError` with the
    compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    seconds = {name: 0.0 for name in names}
    running = {}
    t0 = time.perf_counter()
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, lib, tmp)
    failures = []
    for name, (proc, lib, tmp) in running.items():
        output, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        lib.with_suffix(".log").write_text(output)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed on {name}.cu "
                            f"(exit {proc.returncode}):\n{output}")
            continue
        os.replace(tmp, lib)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source `name`, building it first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LOADED.get(name)
            if lib is None:
                path = library_path(name)
                if not path.exists():
                    build((name,))
                lib = ctypes.CDLL(str(path))
                _LOADED[name] = lib
    return lib
