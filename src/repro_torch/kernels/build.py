"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each source under ``src/repro_torch/csrc/`` compiles, at first use, into
its own shared library with a plain C interface in ``src/repro_torch/
_build/`` (listed in ``.gitignore``). The file name carries a hash of the
source and the flags, so an edited source is rebuilt and never confused
with a stale library. Sources build in parallel: one ``nvcc`` process
each, all started together.

Nothing here runs at import time: the CPU tests import every module, and
the CPU has no ``nvcc``."""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

#: kernel name -> source file under csrc/
SOURCES = {"elastic_update": "elastic_update.cu",
           "flash_attention": "flash_attention.cu",
           "flash_attention_sm90": "flash_attention_sm90.cu",
           "ssd_scan": "ssd_scan.cu"}

#: -fmad=false keeps every multiply and add separately rounded, as in the
#: plain PyTorch versions, so the card checks K1 bit for bit. The inner
#: products of K2 and K3 are explicit fmaf() calls, which the flag leaves
#: fused.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")


@dataclasses.dataclass
class BuildRecord:
    name: str
    path: str
    seconds: float           # 0.0 when the library was already built
    ptxas: str               # nvcc's -Xptxas -v report (registers, spills)


_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_RECORDS: Dict[str, BuildRecord] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
            "kernels are built from source on the machine with the card")
    return found


def _target(name: str) -> str:
    src = os.path.join(CSRC_DIR, SOURCES[name])
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:12]}.so")


def build_all(names: Optional[Iterable[str]] = None
              ) -> Dict[str, BuildRecord]:
    """Compile every named kernel (default: all) that has no library yet,
    all ``nvcc`` processes at once. Raises with the compiler's output if
    any build fails."""
    names = list(SOURCES if names is None else names)
    with _LOCK:
        os.makedirs(BUILD_DIR, exist_ok=True)
        pending = {}
        for name in names:
            if name in _RECORDS:
                continue
            out = _target(name)
            if os.path.exists(out):
                _RECORDS[name] = BuildRecord(name, out, 0.0, "")
                continue
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC_DIR, SOURCES[name])]
            pending[name] = (out, tmp, time.perf_counter(), subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for name, (out, tmp, t0, proc) in pending.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
                continue
            os.replace(tmp, out)
            _RECORDS[name] = BuildRecord(name, out,
                                         time.perf_counter() - t0, log)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        return {n: _RECORDS[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if need be."""
    lib = _LIBS.get(name)
    if lib is None:
        rec = build_all([name])[name]
        with _LOCK:
            lib = _LIBS.setdefault(name, ctypes.CDLL(rec.path))
    return lib
