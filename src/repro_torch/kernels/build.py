"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel is one source under `csrc/` with a plain C interface, compiled
for Hopper (`sm_90a`) into a shared library at first use. Libraries land in
`_build/<source-hash>/` beside this file (listed in `.gitignore`), so an
edited source rebuilds and an unchanged one loads from disk. Nothing here
runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Tuple

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_ROOT = _HERE / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# kernel name -> (source file, {C symbol: argtypes})
KERNELS: Dict[str, Tuple[str, Dict[str, list]]] = {
    "slot_ffn": ("slot_ffn.cu", {
        "slot_ffn_launch": [_P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _P]}),
    "fused_moe_entry": ("fused_moe_entry.cu", {
        "fused_moe_entry_launch": [_P] * 13 + [_I] * 7 + [_P]}),
    "fused_decode_attention": ("fused_decode_attention.cu", {
        "fused_decode_attention_launch": [_P] * 6 + [_I] + [_P] * 3
        + [_I] * 5 + [_F, _F, _P]}),
    "fused_mla_decode_attention": ("fused_mla_decode_attention.cu", {
        "fused_mla_decode_attention_launch": [_P] * 7 + [_I] + [_P] * 3
        + [_I] * 5 + [_F, _P]}),
    "topk_gating": ("topk_gating.cu", {
        "topk_gating_launch": [_P, _I, _P, _P, _I, _I, _I, _I, _P]}),
    "expert_ffn": ("expert_ffn.cu", {
        "expert_ffn_launch": [_P] * 6 + [_I] * 4 + [_P]}),
}


class KernelLibraries:
    """Built-and-loaded kernel libraries, keyed by kernel name. One instance
    per process (`LIBS`) so a library loads once; `build_log` keeps the
    compiler's report (registers, spills) and `build_seconds` the time each
    build took (0 when loaded from an earlier build)."""

    def __init__(self):
        self._libs: Dict[str, ctypes.CDLL] = {}
        self.build_log: Dict[str, str] = {}
        self.build_seconds: Dict[str, float] = {}

    def get(self, name: str) -> ctypes.CDLL:
        if name not in self._libs:
            self.build(name)
        return self._libs[name]

    def build(self, *names: str) -> None:
        """Compile every named kernel that is not built yet, one nvcc process
        per source, all started together; then load them."""
        names = names or tuple(KERNELS)
        todo = {n: _lib_path(n) for n in names if n not in self._libs}
        procs = {}
        t0 = time.perf_counter()
        for n, path in todo.items():
            if path.exists():
                self.build_seconds[n] = 0.0
                continue
            procs[n] = _start_nvcc(n, path)
        failed = []
        for n, (proc, tmp, path) in procs.items():
            out, _ = proc.communicate()
            self.build_log[n] = out
            self.build_seconds[n] = time.perf_counter() - t0
            if proc.returncode != 0:
                os.remove(tmp)
                failed.append(f"nvcc failed for {n}:\n{out}")
            else:
                os.replace(tmp, path)
        if failed:
            raise RuntimeError("\n".join(failed))
        for n, path in todo.items():
            lib = ctypes.CDLL(str(path))
            for sym, argtypes in KERNELS[n][1].items():
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            self._libs[n] = lib


def _sources_hash(name: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):       # headers shared between kernels
        if p.suffix in (".cu", ".cuh", ".h"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    h.update(name.encode())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_ROOT / _sources_hash(name) / f"lib{name}.so"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def _start_nvcc(name: str, path: Path):
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / KERNELS[name][0])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, path


LIBS = KernelLibraries()


def build_all() -> Dict[str, float]:
    """Build (or load) every kernel; returns seconds per kernel."""
    LIBS.build()
    return dict(LIBS.build_seconds)
