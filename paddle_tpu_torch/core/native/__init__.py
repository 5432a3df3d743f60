"""The port's native host runtime: C++ sources built with g++ at first use
(counterpart of paddle_tpu/core/native/__init__.py).

``ps_table.cc`` (the parameter server's tables and TCP service),
``data_feed.cc`` (the MultiSlot parser, in-memory store and shuffle behind
the fleet datasets) and ``tokenizer.cc`` (the FasterTokenizer's basic
tokenizer and WordPiece, text/faster_tokenizer.py) are byte-for-byte copies
of the JAX package's sources, so tables and feeds of either package speak
the same wire protocol, draw the same per-id initial rows and write the
same files, and both tokenizers give the same ids. They run on the host:
the card runs the dense compute around them. This split is the design.

``load_library(name)`` compiles ``<name>.cc`` with ``g++ -O2 -std=c++17
-shared -fPIC -pthread`` into ``build/`` beside this file (git-ignored), under
a name keyed by a hash of the source and flags, and loads it with ctypes.
Concurrent processes build to per-process temporary names and rename the
result into place. There is no Python fallback: a missing ``g++`` or a failed
build raises with the compiler's message, as the CUDA kernels' ``nvcc`` build
does (ops/kernels/_build.py).
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import struct
import subprocess
import threading
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR / "build"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_libs = {}


def library_path(name: str) -> Path:
    """Build output for ``<name>.cc``, keyed by the source and the flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update((SRC_DIR / f"{name}.cc").read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _elf_intact(path: Path) -> bool:
    """The ELF magic is there and the section-header table that the header
    promises fits inside the file. An interrupted build leaves the header
    (written first) over a truncated body: rebuild that. A whole file that
    does not load is an environment fault that a rebuild would repeat."""
    try:
        size = path.stat().st_size
        with open(path, "rb") as f:
            hdr = f.read(64)
    except OSError:
        return False
    if len(hdr) < 64 or hdr[:4] != b"\x7fELF":
        return False
    end = "<" if hdr[5] == 1 else ">"
    if hdr[4] == 2:
        (e_shoff,) = struct.unpack_from(end + "Q", hdr, 0x28)
        e_shentsize, e_shnum = struct.unpack_from(end + "HH", hdr, 0x3A)
    else:
        (e_shoff,) = struct.unpack_from(end + "I", hdr, 0x20)
        e_shentsize, e_shnum = struct.unpack_from(end + "HH", hdr, 0x2E)
    return size >= e_shoff + e_shentsize * e_shnum


def _compile(name: str, out: Path) -> None:
    cmd = ["g++", *CXX_FLAGS, str(SRC_DIR / f"{name}.cc"), "-o", str(out)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ not found: the native {name} library is built "
                           f"with the system's C++ compiler ({e})") from e
    except subprocess.CalledProcessError as e:
        with contextlib.suppress(OSError):
            out.unlink()
        raise RuntimeError(f"native {name} build failed:\n{e.stderr}") from e


def build_library(name: str) -> Path:
    """Compile ``<name>.cc`` unless its library is built; return its path.
    Raises RuntimeError with the compiler's output."""
    out = library_path(name)
    if out.exists() and _elf_intact(out):
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a per-process temporary: ranks that build at once never rename
    # another's half-written file into place
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    _compile(name, tmp)
    os.replace(tmp, out)
    return out


def load_library(name: str) -> ctypes.CDLL:
    """ctypes handle of a native component, built on first use. Raises when
    it cannot be built or loaded."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(build_library(name)))
        return _libs[name]
