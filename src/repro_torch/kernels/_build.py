"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, compiled for Hopper (``sm_90a``).  All sources are compiled
together, one ``nvcc`` process per source started at once.  Libraries go
to ``build/kernels/<hash>/`` at the root of the checkout, keyed by a hash
of every file under ``csrc/`` and of the flags, so an edited source is
rebuilt and an unchanged one is reused.  Nothing is built when a module is
imported: :func:`load` builds at first use.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("jsaq_route", "care_route", "serve_route", "moe_route", "flash_attn",
           "moe_route_bwd", "flash_attn_bwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class BuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise BuildError("nvcc not found (looked on PATH and in /usr/local/cuda/bin)")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / _source_hash()


def build_all(names=KERNELS) -> dict[str, float]:
    """Compile every missing library, all ``nvcc`` processes at once.

    Returns the seconds each compile took (0.0 for a library already
    built).  The compiler's report (``-Xptxas -v``: registers, shared
    memory, spills) is kept beside each library as ``lib<name>.log``.
    """
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {}
    for name in names:
        lib = out / f"lib{name}.so"
        if lib.exists():
            seconds[name] = 0.0
            continue
        tmp = out / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
            tmp,
            lib,
            time.perf_counter(),
        )
    failed = []
    for name, (proc, tmp, lib, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (out / f"lib{name}.log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
    if failed:
        raise BuildError("nvcc failed for " + "\n".join(failed))
    return seconds


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The library of kernel ``name``, built first if needed."""
    lib_path = build_dir() / f"lib{name}.so"
    if not lib_path.exists():
        build_all((name,))
    return ctypes.CDLL(str(lib_path))
