"""Build and load the port's CUDA kernels.

The kernels live as CUDA C++ under ``repro_torch/csrc/``.  Each source is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library with a
plain C interface and loaded with ``ctypes`` — no PyTorch headers, so a
build takes seconds.  Builds happen at first use, never at import, into
``repro_torch/csrc/build/`` under a name that carries a hash of the source,
the shared headers and the flags, so an edited source is rebuilt and a
stale library never loads.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = (CSRC / "fedadc_kernels.cu", CSRC / "compress_kernels.cu",
           CSRC / "kd_kernels.cu", CSRC / "attention_kernels.cu",
           CSRC / "ssd_kernels.cu")
# -Xptxas -v puts each kernel's registers and spills in the build log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_F = ctypes.c_float
_INT = ctypes.c_int
# argtypes of every C entry point, by the source that defines it: pointers
# and the stream as c_void_p, so ctypes never truncates a 64-bit address to
# an int.  Every source also defines ``fedadc_error_string``.
SIGNATURES = {
    SOURCES[0]: {
        "fedadc_fused_axpy_leaves": [_P, _I64, _P, _F, _INT, _P],
        "fedadc_local_update_leaves": [_P, _I64, _P, _F, _INT, _P],
        "fedadc_server_update_leaves": [_P, _I64, _P, _P, _F, _F, _F, _INT,
                                        _INT, _P],
        "fedadc_weighted_reduce_leaves": [_P, _I64, _P, _P, _I64, _INT, _P],
    },
    SOURCES[1]: {
        "fedadc_threshold_select_leaves": [_P, _I64, _P, _P, _INT, _P],
        "fedadc_qsgd_leaves": [_P, _I64, _P, _P, _INT, _F, _INT, _P],
        "fedadc_sparse_reduce_leaves": [_P, _I64, _P, _I64, _P, _P, _P,
                                        _P, _INT, _INT, _P],
    },
    SOURCES[2]: {
        "fedadc_kd_loss_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64,
                               _I64, _I64, _F, _F, _INT, _P],
        "fedadc_kd_loss_bwd": [_P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64,
                               _F, _F, _F, _I64, _INT, _P],
    },
    SOURCES[3]: {
        "fedadc_flash_attention": [_P, _P, _P, _P, _I64, _I64, _I64, _I64,
                                   _I64, _I64, _INT, _INT, _F, _INT, _P],
    },
    SOURCES[4]: {
        "fedadc_ssd_scan": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64,
                            _I64, _I64, _I64, _I64, _I64, _INT, _INT, _P],
    },
}
# the source of every entry point
ENTRY_SOURCE = {name: src for src, names in SIGNATURES.items()
                for name in names}

_LIBS: Dict[Path, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (on PATH or under /usr/local/cuda)")
    return path


def library_path(source: Path) -> Path:
    """The library's path, named by a hash of the source, the headers
    beside it (``*.cuh``, which any source may include) and the flags."""
    text = source.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}-{digest}.so"


def build_all(sources=SOURCES) -> List[dict]:
    """Compile every source that has no up-to-date library, one ``nvcc``
    per source, all started together.  -> one record per source: its
    library path, whether it was built now, the seconds that took, and the
    compiler's output.  Raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in sources:
        lib = library_path(src)
        if lib.exists():
            jobs.append((src, lib, None, None, time.perf_counter()))
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((src, lib, tmp, proc, time.perf_counter()))
    records = []
    for src, lib, tmp, proc, t0 in jobs:
        if proc is None:
            records.append({"source": str(src), "library": str(lib),
                            "built": False, "seconds": 0.0, "log": ""})
            continue
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name} "
                               f"(exit {proc.returncode}):\n{log}")
        # atomic publish: a concurrent process never loads a partial file
        os.replace(tmp, lib)
        records.append({"source": str(src), "library": str(lib),
                        "built": True, "seconds": seconds, "log": log})
    return records


def library(source: Path) -> ctypes.CDLL:
    """The loaded library for one source, built first if needed.  Looked up
    once per process: a launch must not pay for hashing the source."""
    lib = _LIBS.get(source)
    if lib is None:
        lib_path = library_path(source)
        if not lib_path.exists():
            build_all((source,))
        lib = ctypes.CDLL(str(lib_path))
        for name, argtypes in SIGNATURES[source].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.fedadc_error_string.argtypes = [ctypes.c_int]
        lib.fedadc_error_string.restype = ctypes.c_char_p
        _LIBS[source] = lib
    return lib


def launch(name: str, *args) -> None:
    """Call one C entry point and raise if it reports a CUDA error."""
    lib = library(ENTRY_SOURCE[name])
    code = getattr(lib, name)(*args)
    if code != 0:
        msg = lib.fedadc_error_string(code).decode()
        raise RuntimeError(f"{name} failed: CUDA error {code} ({msg})")
