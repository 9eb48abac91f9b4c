"""Build the port's CUDA kernels and load them with ctypes.

Each source ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers,
so ``nvcc`` takes seconds) and is compiled for Hopper into
``build/lib<name>-<hash>.so`` at the repository root.  The hash covers the
sources and the flags, so an edited kernel is rebuilt and an unchanged one
is reused.  Nothing is built at import: the first CUDA launch builds its
library, or `build_all` builds every library ahead of time, one ``nvcc``
per source, all started together.

The compiler's resource report (``-Xptxas -v``: registers, shared memory,
spills) is kept beside each library as ``<lib>.log``.  `launch` binds and
calls a C entry point; every entry point returns its cudaError_t, and a
failure raises with the library's ``<lib>_error_string``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("gemm", "gemm_bwd", "flash_attention", "flash_attention_bwd",
           "flash_decode", "ssd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_FNS: dict = {}  # entry name -> bound C function
_LOCK = threading.Lock()


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, or
    the one on ``PATH``.  Raises RuntimeError when there is none."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives: the file
    name carries a hash of the sources (headers included) and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> list[Path]:
    """Build every library in `names` that is not built yet, starting one
    ``nvcc`` per source at once; returns the library paths.

    Raises RuntimeError with the compiler's output when a build fails.
    """
    paths = [library_path(n) for n in names]
    todo = [(n, p) for n, p in zip(names, paths) if not p.exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    procs = []
    for name, path in todo:
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, path, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{out}")
            tmp.unlink(missing_ok=True)
            continue
        path.with_name(path.name + ".log").write_text(out)
        os.replace(tmp, path)  # atomic: a concurrent builder sees all or none
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            (path,) = build_all((name,))
            lib = _LIBS[name] = ctypes.CDLL(str(path))
        return lib


def launch(lib: str, entry: str, argtypes: list, stream: int, *args,
           what: str) -> None:
    """Call the C entry point `entry` of ``csrc/<lib>.cu`` (its library
    built and loaded on first use) with `args` and the CUDA `stream` last.
    Every entry point returns a cudaError_t; a non-zero one raises
    RuntimeError naming `what`, with the string of ``<lib>_error_string``.
    """
    fn = _FNS.get(entry)
    if fn is None:
        fn = getattr(load(lib), entry)
        fn.argtypes = [*argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[entry] = fn
    rc = fn(*args, stream)
    if rc != 0:
        err = getattr(load(lib), f"{lib}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        raise RuntimeError(f"{entry} launch failed for {what}: "
                           f"{err(rc).decode()}")
