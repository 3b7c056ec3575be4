"""Build and load the port's CUDA kernels (``repro_torch/csrc``).

Each ``.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes``. The build
runs at first use, into ``repro_torch/csrc/_build`` (listed in
``.gitignore``); the library's file name carries a hash of its source and
of every ``csrc`` header it includes, so an edited source or header is
rebuilt and an unchanged one is reused within a checkout. Nothing here runs at import time: this module imports on a
machine with no CUDA toolkit, and only :func:`load` needs one.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P, _LL, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float

#: C signatures, by source file stem then function name.
SIGNATURES = {
    "cascade_phase1": {
        # float32 only
        "cascade_phase1_dense": [
            _P, _P, _P, _LL, _LL, _LL, _LL, _LL, _LL, _P, _P, _P, _P, _P,
            _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
        "cascade_phase1_paged": [
            _P, _P, _P, _LL, _LL, _LL, _LL, _LL, _LL, _P, _P, _P, _P, _P,
            _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F,
            _P],
    },
    "cascade_phase1_sm90": {
        # bf16 only: q read in place through its strides, the scale apart
        "cascade_phase1_dense_sm90": [
            _P, _P, _P, *[_LL] * 9, _P, _P, _P, _P, _P,
            *[_I] * 9, _I, _I, _F, _F, _P],
        "cascade_phase1_paged_sm90": [
            _P, _P, _P, *[_LL] * 9, _P, _P, _P, _P, _P, _P,
            *[_I] * 10, _I, _I, _I, _F, _F, _P],
    },
    "flash_attention": {
        # inputs, their strides, kv_len, outputs, dims and flags, stream
        "flash_fwd": [
            _P, _P, _P, *[_LL] * 9, _P, _P, _LL, _LL, _LL, _P,
            *[_I] * 6, _I, _I, _I, _F, _F, _I, _P],
        "flash_bwd_dq": [
            _P, _P, _P, _P, *[_LL] * 12, _P, _P, _P, _P, _LL, _LL, _LL,
            *[_I] * 6, _I, _I, _I, _F, _F, _I, _P],
        "flash_bwd_dkv": [
            _P, _P, _P, _P, *[_LL] * 12, _P, _P, _P, _P, _LL, _LL, _LL,
            _P, _LL, _LL, _LL, *[_I] * 6, _I, _I, _I, _F, _F, _I, _P],
    },
    "flash_attention_sm90": {
        # the signatures of flash_fwd, flash_bwd_dq and flash_bwd_dkv;
        # bf16 only
        "flash_fwd_sm90": [
            _P, _P, _P, *[_LL] * 9, _P, _P, _LL, _LL, _LL, _P,
            *[_I] * 6, _I, _I, _I, _F, _F, _I, _P],
        "flash_bwd_dq_sm90": [
            _P, _P, _P, _P, *[_LL] * 12, _P, _P, _P, _P, _LL, _LL, _LL,
            *[_I] * 6, _I, _I, _I, _F, _F, _I, _P],
        "flash_bwd_dkv_sm90": [
            _P, _P, _P, _P, *[_LL] * 12, _P, _P, _P, _P, _LL, _LL, _LL,
            _P, _LL, _LL, _LL, *[_I] * 6, _I, _I, _I, _F, _F, _I, _P],
    },
}

_loaded = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit on PATH or under /usr/local/cuda")


def sources(stem: str) -> list:
    """``csrc/<stem>.cu`` and every ``csrc`` header it includes (by
    ``#include "..."``, also through other headers), in include order."""
    out, todo = [], [CSRC / f"{stem}.cu"]
    while todo:
        path = todo.pop(0)
        if path in out:
            continue
        out.append(path)
        todo += [CSRC / name for name in re.findall(
            r'^\s*#\s*include\s+"([^"]+)"', path.read_text(), re.M)]
    return out


def _lib_path(stem: str) -> Path:
    digest = hashlib.sha256()
    for path in sources(stem):
        digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{stem}_{digest.hexdigest()[:16]}.so"


def compile_source(stem: str) -> Path:
    """nvcc ``csrc/<stem>.cu`` into the build directory (skipped when the
    library for this source hash is there). Writes the compiler's
    register/shared-memory report to ``<lib>.log``."""
    out = _lib_path(stem)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
           str(CSRC / f"{stem}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {stem}.cu:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def build_all() -> dict:
    """Compile every source at once, one nvcc process each."""
    with ThreadPoolExecutor(max_workers=len(SIGNATURES)) as pool:
        futs = {stem: pool.submit(compile_source, stem)
                for stem in SIGNATURES}
        return {stem: f.result() for stem, f in futs.items()}


def load(stem: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<stem>.cu``, built if needed."""
    if stem not in _loaded:
        lib = ctypes.CDLL(str(compile_source(stem)))
        for name, argtypes in SIGNATURES[stem].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded[stem] = lib
    return _loaded[stem]


def build_log(stem: str) -> str:
    log = _lib_path(stem).with_suffix(".log")
    return log.read_text() if log.exists() else ""
