"""Build the CUDA kernels in ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes plain C functions (pointers and the stream
as ``void*``, each returning ``cudaGetLastError()``). It is compiled by
``nvcc`` for ``sm_90a`` into a shared library under ``build/`` (git-ignored)
the first time a wrapper needs it. The library's file name carries a hash
of the sources and flags, so an edited source is rebuilt and an unchanged
one is loaded as it is. Sources that are missing their library are compiled
in parallel, one ``nvcc`` each.

Nothing here runs when the package is imported: the CPU has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> list:
    """Names of every kernel source (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


def library_path(name: str) -> Path:
    """Build output for ``csrc/<name>.cu``, keyed by a hash of the source,
    the shared headers and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None, force: bool = False) -> Dict[str, float]:
    """Compile every named source whose library is missing (every one with
    ``force``), all at once. Returns {name: seconds} for the sources compiled
    (0.0 when cached). Raises with nvcc's output if any compile fails."""
    names = list(sources() if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: 0.0 for n in names}
    todo = [n for n in names if force or not library_path(n).exists()]
    if not todo:
        return out
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        final = library_path(n)
        tmp = final.with_name(f"{final.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, final)
    errors = []
    for n, (proc, tmp, final) in procs.items():
        log, _ = proc.communicate()
        out[n] = time.perf_counter() - t0
        final.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu (exit {proc.returncode}):"
                          f"\n{log}")
            continue
        os.replace(tmp, final)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and spill report) of the last build."""
    p = library_path(name).with_suffix(".log")
    return p.read_text() if p.exists() else ""


def ptxas_report(name: str) -> Dict[str, Dict[str, int]]:
    """{kernel (mangled name): {"registers", "spill_stores", "spill_loads"}}
    from ptxas's report in the last build's log."""
    out: Dict[str, Dict[str, int]] = {}
    fn = None
    for line in build_log(name).splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$.]+)'?",
                      line)
        if m:
            fn = m.group(1)
            out.setdefault(fn, {})
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[fn]["spill_stores"], out[fn]["spill_loads"] = int(m[1]), int(m[2])
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[fn]["registers"] = int(m[1])
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib
