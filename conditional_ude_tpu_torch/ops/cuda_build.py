"""Build and bind the port's CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface.  ``nvcc``
compiles it for ``sm_90a`` at first use into ``build/`` at the repository
root, under a name that hashes the source, the shared ``csrc/*.cuh``
headers and the flags, so an edited kernel rebuilds itself.  The library is
loaded with ``ctypes``.  Nothing here runs when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
# -fmad=false: no contracted multiply-adds, so a kernel performs its plain
# version's operations in the plain version's order; no fast math.
# -Xptxas -v reports registers, stack and spills into the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC")


def nvcc_command(source: Path, output: Path) -> list[str]:
    """The ``nvcc`` command line that builds ``source`` into ``output``."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = "nvcc" if CUDA_HOME is None else str(Path(CUDA_HOME) / "bin" / "nvcc")
    return [nvcc, *NVCC_FLAGS, "-o", str(output), str(source)]


def library_path(source: Path) -> Path:
    key = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        key.update(header.read_bytes())
    key.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{key.hexdigest()[:16]}.so"


def build_all(sources: list[Path]) -> dict[Path, tuple[Path, float, str]]:
    """Build every source that has no library yet, one ``nvcc`` each, all
    started together.  Returns ``{source: (library, seconds, log)}``;
    ``log`` is what ``nvcc`` printed (ptxas registers and spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pending, out = {}, {}
    for src in sources:
        lib = library_path(src)
        if lib.exists():
            log = lib.with_suffix(".log")
            out[src] = (lib, 0.0, log.read_text() if log.exists() else "")
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp.so")
        proc = subprocess.Popen(nvcc_command(src, tmp), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        pending[src] = (lib, tmp, proc, time.perf_counter())
    for src, (lib, tmp, proc, t0) in pending.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name} "
                               f"({proc.returncode}):\n{log}")
        os.replace(tmp, lib)
        lib.with_suffix(".log").write_text(log)
        out[src] = (lib, time.perf_counter() - t0, log)
    return out


class KernelLibrary:
    """One kernel's shared library, built and loaded at first use.

    ``name`` and ``argtypes`` declare its C entry point, which launches on
    the stream it is given and returns ``cudaGetLastError()``; a call
    raises ``RuntimeError`` when that is not 0.  A negative return is the
    entry point's refusal of inputs that need more shared memory a block
    than the card has (minus the bytes) and raises ``ValueError``.
    """

    def __init__(self, source: str, name: str, argtypes: list):
        self.source = CSRC / source
        self.name = name
        self.argtypes = argtypes
        self._fn = None

    def build(self) -> Path:
        return build_all([self.source])[self.source][0]

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(ctypes.CDLL(str(self.build())), self.name)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err < 0:
            raise ValueError(f"{self.name}: these inputs need {-err} bytes "
                             "of shared memory a block, more than the card "
                             "has")
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {err}")


VP, I64, I32, F32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                     ctypes.c_float)
F32_PTR = ctypes.POINTER(ctypes.c_float)
