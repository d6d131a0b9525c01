"""Build the CUDA kernels from ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
its own by ``nvcc`` into ``build/repro_torch_kernels/<name>-<hash>.so``
at the root of the checkout (listed in ``.gitignore``), at first use.
The hash covers the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source or header never loads a stale library.  Nothing is built when the package is imported:
the first call of a kernel wrapper builds what it needs, and
:func:`build` compiles several sources at once, one ``nvcc`` each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

SOURCES = ("tile_sort", "splitter_partition", "splitter_ranks", "topk",
           "radix_sort", "merge_sort")

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


class LaunchCounter:
    """Launches of one kernel: its wrapper adds one per launch."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def add(self) -> None:
        self.count += 1

    def reset(self) -> None:
        self.count = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "of repro_torch are built from source at first use"
        )
    return path


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is (or will be) built."""
    src = (_CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(_CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(_FLAGS).encode()).hexdigest()[:12]
    return _BUILD_DIR / f"{name}-{digest}.so"


def build(names=SOURCES) -> None:
    """Compile every named source whose library is missing, all at once.

    Raises:
        RuntimeError: naming the source and carrying nvcc's output when
            a compile fails.
    """
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *_FLAGS, "-o", tmp, str(_CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, library_path(name))
        else:
            os.unlink(tmp)
            failed.append(name)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if missing.

    Every source exports ``const char* repro_error_string(int)``
    (``cudaGetErrorString``), declared here.
    """
    with _LOCK:
        if name not in _LIBS:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return _LIBS[name]


def word_ptrs(tensors) -> list:
    """Pointers [word 0, word 1 or None, payload] of 1-2 key-word tensors
    followed by their payload, as the C interfaces take them; three
    Nones for an empty list (an output the launch does not write)."""
    if not tensors:
        return [None] * 3
    ptrs = [t.data_ptr() for t in tensors]
    return ptrs[:-1] + [None] * (3 - len(ptrs)) + ptrs[-1:]


def check(lib: ctypes.CDLL, err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error (its cudaGetLastError)."""
    if err != 0:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {kernel} failed: error {err} ({msg})")
