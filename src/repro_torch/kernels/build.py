"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/repro_torch_kernels/<name>-<hash>.so`` at the repo root, at
first use, for Hopper (``sm_90a``).  The hash covers the source and the
flags, so an edited source is never served by a stale library.  All
sources that need building are compiled at once, one ``nvcc`` each.

Nothing here runs at import: the CPU tests import every module of the
port on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
#: src/repro_torch/kernels/build.py -> the repo root
ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = ROOT / "build" / "repro_torch_kernels"
SOURCES: Tuple[str, ...] = ("paged_attention", "flash_attention",
                            "flash_attention_bwd", "moe_gating",
                            "moe_gating_bwd", "mlstm_scan")
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from source")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Iterable[str] = SOURCES,
          verbose: bool = False) -> Dict[str, str]:
    """Compile every named source that has no library yet, all in
    parallel.  Returns ``{name: compiler output}`` (``-Xptxas -v`` register
    and spill report when ``verbose``).  Raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List[Tuple[str, subprocess.Popen, Path, Path]] = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS,
               *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out))
    logs: Dict[str, str] = {}
    failed: List[str] = []
    for name, proc, tmp, out in procs:
        text, _ = proc.communicate()
        logs[name] = text
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{text}")
            continue
        os.replace(tmp, out)          # atomic: readers never see half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str,
         signatures: Dict[str, Tuple[object, Sequence[object]]]) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``, declaring
    ``restype``/``argtypes`` for each exported C function."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn_name, (restype, argtypes) in signatures.items():
            fn = getattr(lib, fn_name)
            fn.restype = restype
            fn.argtypes = list(argtypes)
        _loaded[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
