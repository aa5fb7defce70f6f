"""Build ``csrc/*.cu`` with ``nvcc`` into shared libraries and load them with
``ctypes``.

Each source has a plain C interface, so a build takes seconds and needs no
PyTorch headers.  Libraries go to ``kernels/build/`` (ignored by git), named
by a hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is reused.  Nothing is built when the package is imported:
the first launch on a CUDA tensor builds what it needs, and
``build_all`` starts one ``nvcc`` per source, all at once.  A library's
name also hashes the headers of ``csrc/`` (``sturm_device.cuh``), so an
edited header rebuilds the sources that include it.

Both entries hold one lock of the process, so two threads that ask for
the same source (a serving engine's dispatcher and its caller) run one
build and load one library; a temporary file is named by process and
thread.  A build that ``load`` performs runs under a ``build`` span
(``kernel=<name>``) of the ambient tracer (``repro_torch.obs``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from repro_torch import obs

__all__ = ["SOURCES", "FLAGS", "build_all", "load", "nvcc_command", "LOGS",
           "count_launch"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
SOURCES = {"chase": "chase.cu", "sturm": "sturm.cu", "hh_apply": "hh_apply.cu",
           "fused_small": "fused_small.cu", "flash_attn": "flash_attn.cu",
           "flash_attn_wgmma": "flash_attn_wgmma.cu", "dc": "dc.cu",
           "flash_attn_bwd": "flash_attn_bwd.cu",
           "flash_attn_bwd_wgmma": "flash_attn_bwd_wgmma.cu"}
# No --use_fast_math: the kernels need IEEE division, sqrt and subnormals.
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LOGS: dict[str, str] = {}          # compiler output (ptxas -v) per source
_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.RLock()          # held by build_all and load
_COUNT_LOCK = threading.Lock()     # the wrappers' launch counts


def count_launch(table: dict, key: str) -> None:
    """Add one to a wrapper's launch count, under a lock: the shards of a
    mesh launch from threads of their own (``core/distributed.py``)."""
    with _COUNT_LOCK:
        table[key] += 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def nvcc_command(source: Path, target: Path) -> list[str]:
    """The command that builds one source into a shared library."""
    return [_nvcc(), *FLAGS, "-o", str(target), str(source)]


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):       # what a source includes
        h.update(header.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, Path]:
    """Build the named sources (default: all) that are not built yet, one
    ``nvcc`` process each, all started together.  Returns name -> library
    path; raises with the compiler's output when a build fails."""
    names = list(SOURCES if names is None else names)
    with _LOCK:
        return _build_all(names)


def _build_all(names: list[str]) -> dict[str, Path]:
    BUILD.mkdir(parents=True, exist_ok=True)
    out, procs = {}, {}
    for name in names:
        target = _target(name)
        out[name] = target
        if target.exists():
            continue
        tmp = target.with_name(
            f"{target.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = nvcc_command(CSRC / SOURCES[name], tmp)
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"{SOURCES[name]}:\n{log}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if _target(name).exists():
                path = build_all([name])[name]
            else:
                with obs.span("build", kernel=name):
                    path = build_all([name])[name]
            lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib
