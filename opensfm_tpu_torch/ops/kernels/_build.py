"""Build and load the CUDA kernels of `opensfm_tpu_torch/csrc/`.

Each source is compiled by `nvcc` for Hopper (`sm_90a`) into a shared
library with a plain C interface, at first use, under `build/kernels/` in
the checkout, and loaded with ctypes.  The library's file name carries a
hash of its source and of the shared headers, so an edited source is
rebuilt and never mixed with an old binary.  `build_all` compiles several
sources at once, one `nvcc` each.  Nothing is built when a module is imported: the CPU tests
import every module on a machine without `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, Tuple

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    # No FMA contraction: the kernels then round op by op like their plain
    # PyTorch twins, so the two agree to the last bits the math libraries
    # allow.  They are memory-bound; the extra multiplies cost nothing.
    "-fmad=false",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# source name -> (seconds spent compiling, ptxas report); 0 s when cached,
# with the report kept beside the library when it was built.
BUILD_LOG: Dict[str, Tuple[float, str]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(source: str) -> Path:
    """Where `source` (a file name in csrc/) builds to: the name hashes the
    source and every header of csrc/."""
    h = hashlib.sha256()
    for path in [CSRC / source, *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(source: str) -> Path:
    """Compile `source` unless its library exists; returns the library path.
    Raises RuntimeError with nvcc's output when the compile fails."""
    out = library_path(source)
    report = out.with_suffix(".ptxas")
    if out.exists():
        kept = report.read_text() if report.exists() else ""
        BUILD_LOG.setdefault(source, (0.0, kept))
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    try:
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {source} ({proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        report.write_text(proc.stderr)
        os.replace(tmp, out)  # atomic: concurrent builders agree
    finally:
        if tmp.exists():
            tmp.unlink()
    BUILD_LOG[source] = (time.perf_counter() - t0, proc.stderr)
    return out


def build_all(sources) -> Dict[str, Path]:
    """Compile `sources` concurrently (one nvcc process each); returns
    {source: library path}.  Raises the first compile error."""
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        futures = {s: pool.submit(build, s) for s in sources}
        return {s: f.result() for s, f in futures.items()}


def load(source: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """Build (if needed) and load `source`; `bind` declares the argtypes."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            bind(lib)
            _loaded[source] = lib
        return lib
