"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into an
object file (all sources at once, one process each; ``csrc/*.cuh`` headers
are included from there and hashed with them), the objects are linked
into one shared library with a plain C interface, and the library is loaded
with ``ctypes``. The build happens on first use, into
``<repo>/build/kernels/<hash>/`` keyed on a hash of the sources and flags, so
a fresh checkout builds everything by itself and a rebuilt source never
loads a stale library. ``set_defines`` switches to a build with extra
``-D`` macros (an instrumented variant, e.g. ``MEGA_PHASES``), built and
cached the same way. Nothing here runs at import time.
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

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "librtfd_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# C entry points: argument types (every one returns a cudaError_t as int)
SIGNATURES = {
    # one EpilogueArgs struct by address, the stream
    "rtfd_epilogue_packed": [_P, _P],
    "rtfd_epilogue_args_bytes": [],
    # an empty kernel on the epilogue's grid (the launch floor)
    "rtfd_empty": [_I, _P],
    "rtfd_flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _L, _L, _L, _L, _L, _L, _L, _L, _L, _F, _P],
    "rtfd_dequant_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "rtfd_dequant_rows": [_P, _P, _P, _P, _I, _I, _I, _P],
    # one MegaArgs struct by address, the grid size, the stream
    "rtfd_megakernel": [_P, _I, _P],
    "rtfd_megakernel_smem_bytes": [_P],
}

_lib = None
_lock = threading.Lock()
_defines: tuple[str, ...] = ()


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cuh"))


def _flags(defines: tuple[str, ...]) -> list[str]:
    return [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]


def source_hash(defines: tuple[str, ...] = ()) -> str:
    h = hashlib.sha256(" ".join(_flags(defines)).encode())
    for path in sources() + headers():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def build_library(build_root: Path = BUILD_ROOT, verbose: bool = False,
                  defines: tuple[str, ...] = ()) -> Path:
    """Compile the kernels (with ``-D`` for each of ``defines``) unless this
    source hash was built already; returns the library path. Raises with the
    compiler's output on failure."""
    flags = _flags(defines)
    out_dir = build_root / source_hash(defines)
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    nvcc = find_nvcc()
    build_root.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=build_root))
    extra = ("-Xptxas", "-v") if verbose else ()
    procs = []
    for src in sources():
        obj = tmp / (src.stem + ".o")
        cmd = [nvcc, *flags, *extra, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures, objects = [], []
    for src, obj, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{src.name}:\n{log}")
        elif verbose and log:
            print(f"[nvcc {src.name}]\n{log}", flush=True)
        objects.append(str(obj))
    if failures:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    link = subprocess.run(
        [nvcc, *flags, "-shared", *objects, "-o", str(tmp / LIB_NAME)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError("kernel link failed:\n" + link.stdout)
    try:
        os.replace(tmp, out_dir)
    except OSError:
        # another process finished the same build first
        shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


def set_defines(*defines: str) -> None:
    """Build and load the kernels with these extra ``-D`` macros from the
    next ``kernel_library()`` call on (``set_defines()`` goes back to the
    plain build)."""
    global _defines, _lib
    with _lock:
        _defines, _lib = tuple(defines), None


def kernel_library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library(defines=_defines)))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check_launch(name: str, code: int) -> None:
    """Raise when a kernel's C entry point reports a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")
