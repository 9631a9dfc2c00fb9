"""Build the kernels' CUDA sources with ``nvcc`` and load them with ctypes.

Each family's ``csrc/*.cu`` compiles into its own shared library with a
plain ``extern "C"`` interface, for ``sm_90a`` only.  Libraries land in
``build/repro_torch/`` at the repository root (git-ignored), named by a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one is loaded as it is.  Nothing is built when a module is
imported: the first launch builds its own library, and :func:`build_all`
builds every library at once, one ``nvcc`` process per source, all started
together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

__all__ = ["SOURCES", "build_all", "build_log", "library"]

_KERNELS = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS.parents[2] / "build" / "repro_torch"
COMMON_DIR = _KERNELS / "csrc"
SOURCES = {
    "paged_attention": _KERNELS / "paged_attention" / "csrc"
    / "paged_attention.cu",
    "paged_segment_attention": _KERNELS / "segment_attention" / "csrc"
    / "paged_segment_attention.cu",
    "segment_attention": _KERNELS / "segment_attention" / "csrc"
    / "segment_attention.cu",
    "rglru_scan": _KERNELS / "rglru" / "csrc" / "rglru_scan.cu",
    "rwkv6_scan": _KERNELS / "rwkv6" / "csrc" / "rwkv6_scan.cu",
    "flash_attention": _KERNELS / "flash_attention" / "csrc"
    / "flash_attention.cu",
    "flash_attention_bwd": _KERNELS / "flash_attention" / "csrc"
    / "flash_attention_bwd.cu",
    "decode_attention": _KERNELS / "decode_attention" / "csrc"
    / "decode_attention.cu",
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): the "
                           "kernels build with nvcc at first use")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [SOURCES[name], *sorted(COMMON_DIR.glob("*.cuh"))]:
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _compile(names: list[str]) -> None:
    """Run one nvcc per missing library, all at once; raise on any error."""
    todo = [(n, _target(n)) for n in names if not _target(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, out in todo:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, f"-I{COMMON_DIR}", "-o", str(tmp),
               str(SOURCES[name])]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for name, out, tmp, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name} "
                          f"(exit {proc.returncode}):\n{text}")
            continue
        out.with_suffix(".log").write_text(text)
        os.replace(tmp, out)          # atomic: concurrent builds agree
    if errors:
        raise RuntimeError("\n".join(errors))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel family, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _compile([name])
            lib = _libs[name] = ctypes.CDLL(str(_target(name)))
        return lib


def build_all() -> None:
    """Build every family's library in parallel (one nvcc per source)."""
    with _lock:
        _compile(list(SOURCES))


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills) from
    the build of one family's library; empty before it was built here."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
