"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes`` — no PyTorch headers,
so a build takes seconds. Libraries are built at first use into
``build/repro_torch/`` at the root of the checkout (``.gitignore`` lists
it), named by a hash of the source, the shared headers ``csrc/*.cuh``
that sources include, and the flags, so an edited source or header is
rebuilt and a stale library is never loaded. Nothing here runs at
import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def build_dir() -> pathlib.Path:
    # src/repro_torch/kernels/csrc -> <checkout>/build/repro_torch
    return CSRC.parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "with the CUDA toolkit on the machine with the card")


def library_path(name: str) -> pathlib.Path:
    """Where the library of ``csrc/<name>.cu`` lives for its current
    source, headers and flags. Every ``csrc/*.cuh`` is hashed with each
    source: an edited header rebuilds the sources that may include it."""
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.name.encode() + p.read_bytes()
                       for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"lib{name}-{digest[:16]}.so"


def build(names: list[str] | None = None) -> dict[str, dict]:
    """Compile the named sources (default: every ``csrc/*.cu``) that have
    no library for their current hash yet: one ``nvcc`` per source, all
    started together. Returns ``{name: {"seconds", "log", "cached"}}``
    with the compiler's resource report in ``log`` (kept beside the
    library, so a cached build reports it too); raises on a failed
    compile."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    out: dict[str, dict] = {}
    procs = {}
    build_dir().mkdir(parents=True, exist_ok=True)
    for name in names:
        so = library_path(name)
        if so.exists():
            log = so.with_suffix(".log")
            out[name] = {"seconds": 0.0, "cached": True,
                         "log": log.read_text() if log.exists() else ""}
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so, time.perf_counter())
    failed = []
    for name, (proc, tmp, so, t0) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            continue
        so.with_suffix(".log").write_text(log)
        os.replace(tmp, so)          # atomic: concurrent builds agree
        out[name] = {"seconds": seconds, "log": log, "cached": False}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
