"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with
a plain C interface under ``build/`` at the repository root, on first
use, and loads with ``ctypes`` (every pointer and the stream as
``c_void_p``).  The library's file name carries a hash of its source and
of the shared headers ``csrc/*.cuh``, so an edited kernel or header never
loads a stale build.  Kernels build only from the sources in this
package; a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOADED: dict = {}

#: per kernel: (seconds the build took, compiler output); empty on a reuse
BUILD_LOG: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    """The library path of kernel ``name``, keyed by its source, every
    shared header in ``csrc/`` and the flags."""
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names=None) -> None:
    """Compile every named kernel source (default: all of ``csrc/*.cu``)
    that has no current build, one ``nvcc`` per source, all at once."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)
        BUILD_LOG[name] = (time.perf_counter() - t0, log)


_VP = ctypes.c_void_p
_LL = ctypes.c_longlong

#: per library: its C functions as (argument types, return type); every
#: device pointer and the stream are c_void_p, every size a long long
SIGNATURES = {
    "lane_tick": {
        "lane_tick_launch": ([ctypes.POINTER(_LL), ctypes.POINTER(_VP),
                              ctypes.POINTER(_VP), ctypes.POINTER(_VP), _VP],
                             ctypes.c_int),
        "lane_tick_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
    "bitonic": {
        "bitonic_launch": ([_VP] * 7 + [_LL, _LL, _VP], ctypes.c_int),
        "bitonic_ws_ints": ([_LL, _LL], _LL),
        "bitonic_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
    "merge_consume": {
        "merge_consume_launch": ([_VP] * 9 + [_LL] * 5 + [_VP],
                                 ctypes.c_int),
        "merge_consume_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
    "radix_select": {
        "radix_select_launch": ([_VP] * 5 + [ctypes.POINTER(_LL), _VP],
                                ctypes.c_int),
        "radix_select_ws_ints": ([], _LL),
        "radix_select_device_limits": ([_LL, ctypes.POINTER(_LL)],
                                       ctypes.c_int),
        "radix_select_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed, with
    its C signatures from :data:`SIGNATURES` set."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    build_all([name])
    lib = ctypes.CDLL(str(_target(name)))
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    _LOADED[name] = lib
    return lib
