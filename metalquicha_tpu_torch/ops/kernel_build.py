"""Build and load of the port's hand-written CUDA kernels.

Each kernel is one CUDA C++ source under `csrc/` with a plain C
interface. `KernelLibrary.load` compiles it with nvcc at first use into
`BUILD_DIR` (keyed by a hash of the source and the flags, so a later
process finds the shared object there), loads it with ctypes and declares
its entry points. A source that calls a CUDA library names it
(`libs`, e.g. `("cusolver",)`): each becomes a `-l` flag on nvcc's
command line and is part of the hash. The build runs once per process
however many threads make the first call. A build that fails raises
RuntimeError with nvcc's output; nothing falls back to a plain version.
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

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
#: where the shared objects are kept (`compile_cache.enable` moves it)
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be "
                       "built")


def compile_source(source: Path, stem: str, libs=()) -> Path:
    """The shared object of `source` in BUILD_DIR, compiled with nvcc
    unless a build of the same source, flags and libraries is already
    there."""
    src = Path(source).read_bytes()
    links = [f"-l{lib}" for lib in libs]
    key = hashlib.sha256(
        src + " ".join((*NVCC_FLAGS, *links)).encode()).hexdigest()
    so = BUILD_DIR / f"{stem}-{key[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-o", tmp, str(source), *links],
            capture_output=True, text=True, check=False,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}"
                f"{proc.stderr}"
            )
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


class KernelLibrary:
    """One kernel source `csrc/<stem>.cu`, built and loaded once.

    `entry_points` maps each C function to its argument types; every
    function returns an int (a cudaError_t), and every source also exports
    `mqc_cuda_error_string`. `libs`: the CUDA libraries it links."""

    def __init__(self, stem: str, entry_points: dict, libs=()):
        self.stem = stem
        self.source = CSRC / f"{stem}.cu"
        self.entry_points = entry_points
        self.libs = tuple(libs)
        self.lib = None
        self._lock = threading.Lock()

    def load(self) -> ctypes.CDLL:
        """Compile (once per source hash) and load; safe to call from
        several threads at once."""
        if self.lib is not None:
            return self.lib
        with self._lock:
            if self.lib is None:
                lib = ctypes.CDLL(str(compile_source(
                    self.source, self.stem, self.libs)))
                for name, argtypes in self.entry_points.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                lib.mqc_cuda_error_string.argtypes = [ctypes.c_int]
                lib.mqc_cuda_error_string.restype = ctypes.c_char_p
                self.lib = lib
        return self.lib

    def check(self, err: int, what: str) -> None:
        """Raise if a launch returned a CUDA error."""
        if err != 0:
            msg = self.load().mqc_cuda_error_string(err).decode()
            raise RuntimeError(f"{what} launch failed: {msg} ({err})")
