"""Build the Hopper kernels with nvcc and load them with ctypes.

Each source under `csrc/` compiles on first use into its own shared
library with a plain C interface (`nvcc -gencode arch=compute_90a,
code=sm_90a -O3 -shared -Xcompiler -fPIC`).  Libraries land in
`kernels/build/` (listed in .gitignore), named by a hash of the source,
so an edited source is rebuilt and a stale library is never loaded.
`build_all()` starts one nvcc per source, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("edge_rounds", "simplex_project", "flash_attention",
           "flash_attention_bwd", "decode_attention", "ssd_scan", "moe_gmm",
           "moe_gmm_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the Hopper kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every missing library, one nvcc process per source, all
    started together.  Returns {name: ptxas report} for the sources
    built now (empty for those already built)."""
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = _lib_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    reports, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            continue
        os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


_PTR, _INT, _LONG, _FLOAT = (ctypes.c_void_p, ctypes.c_int, ctypes.c_long,
                             ctypes.c_float)
_SIGNATURES = {
    "edge_rounds": {
        "edge_rounds_launch": [_INT, _INT, _INT, _PTR, _PTR, _PTR, _PTR,
                               _PTR, _PTR, _INT, _INT, _INT, _FLOAT, _INT,
                               _INT, _INT, _INT, _PTR],
        "edge_rounds_bucketed_launch": [_INT, _INT, _INT] + [_PTR] * 10
                                       + [_INT, _PTR, _PTR, _INT, _INT, _INT,
                                          _PTR, _PTR, _INT, _INT, _INT,
                                          _FLOAT, _INT, _PTR],
    },
    "simplex_project": {
        "simplex_project_launch": [_INT, _PTR, _PTR, _PTR, _PTR, _PTR,
                                   _INT, _INT, _INT, _PTR],
    },
    "flash_attention": {
        "flash_attention_fwd_launch": [_INT, _PTR, _PTR, _PTR, _PTR, _INT,
                                       _INT, _INT, _INT, _INT, _INT]
                                      + [_LONG] * 12
                                      + [_FLOAT, _INT, _PTR, _PTR, _PTR,
                                         _PTR],
    },
    "flash_attention_bwd": {
        "flash_attention_bwd_launch": [_INT] + [_PTR] * 11
                                      + [_INT] * 6
                                      + [_LONG] * 24 + [_FLOAT, _INT, _PTR],
    },
    "decode_attention": {
        "decode_attention_launch": [_INT, _INT, _INT] + [_PTR] * 7
                                   + [_INT] * 7 + [_LONG] * 12
                                   + [_FLOAT, _PTR],
    },
    "ssd_scan": {
        "ssd_scan_chunks_launch": [_INT] + [_PTR] * 11 + [_INT] * 6
                                  + [_PTR],
        "ssd_scan_smem": [_INT] * 4,
    },
    "moe_gmm": {
        "moe_gmm_launch": [_INT, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT,
                           _INT, _INT, _PTR],
    },
    "moe_gmm_bwd": {
        "moe_gmm_bwd_launch": [_PTR] * 6 + [_INT] * 5 + [_PTR],
    },
}


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of one kernel library, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")

