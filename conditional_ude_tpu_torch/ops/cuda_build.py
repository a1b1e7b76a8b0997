"""Build and bind the port's CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface.  ``nvcc``
compiles it for ``sm_90a`` at first use into ``build/`` at the repository
root, one library for each network shape it is called for: the hidden
widths are compile-time constants of ``csrc/cude_mlp.cuh``
(``CUDE_WIDTHS``, the canonical ``4, 4`` unless a generated header in
``build/`` defines another list; nvcc splits a ``-D`` value at its commas).
A library's name hashes the source, the shared ``csrc/*.cuh`` headers, the
flags and the widths, so an edited kernel rebuilds itself.  The library is
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


CANONICAL_WIDTHS = (4, 4)


def widths_tag(widths) -> str:
    """``"8_8"`` for hidden widths ``(8, 8)``: a file-name part."""
    return "_".join(str(int(w)) for w in widths)


def widths_header(widths) -> Path:
    """The generated header that defines ``CUDE_WIDTHS`` for a network of
    these hidden widths (written by :func:`build_all`)."""
    return BUILD_DIR / f"cude_widths_{widths_tag(widths)}.h"


def nvcc_command(source: Path, output: Path,
                 widths=CANONICAL_WIDTHS) -> list[str]:
    """The ``nvcc`` command line that builds ``source`` into ``output`` for
    a network of hidden ``widths``; the canonical ``(4, 4)`` is the
    headers' own default and adds nothing."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = "nvcc" if CUDA_HOME is None else str(Path(CUDA_HOME) / "bin" / "nvcc")
    shape = ([] if tuple(widths) == CANONICAL_WIDTHS
             else ["-include", str(widths_header(widths))])
    return [nvcc, *NVCC_FLAGS, *shape, "-o", str(output), str(source)]


def library_path(source: Path, widths=CANONICAL_WIDTHS) -> Path:
    key = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        key.update(header.read_bytes())
    key.update(" ".join(NVCC_FLAGS).encode())
    name = source.stem
    if tuple(widths) != CANONICAL_WIDTHS:
        key.update(f"CUDE_WIDTHS {tuple(widths)}".encode())
        name += f"-w{widths_tag(widths)}"
    return BUILD_DIR / f"{name}-{key.hexdigest()[:16]}.so"


def build_all(jobs: list[tuple[Path, tuple[int, ...]]]) -> dict:
    """Build every ``(source, hidden widths)`` job that has no library yet,
    one ``nvcc`` each, all started together.  Returns ``{job: (library,
    seconds, log)}``; ``log`` is what ``nvcc`` printed (ptxas registers
    and spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pending, out = {}, {}
    for job in jobs:
        src, widths = job
        lib = library_path(src, widths)
        if lib.exists():
            log = lib.with_suffix(".log")
            out[job] = (lib, 0.0, log.read_text() if log.exists() else "")
            continue
        if tuple(widths) != CANONICAL_WIDTHS:
            header = widths_header(widths)
            text = ("#define CUDE_WIDTHS "
                    + ", ".join(str(int(w)) for w in widths) + "\n")
            if not header.exists() or header.read_text() != text:
                tmp_h = header.with_suffix(f".{os.getpid()}.tmp")
                tmp_h.write_text(text)
                os.replace(tmp_h, header)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp.so")
        proc = subprocess.Popen(nvcc_command(src, tmp, widths),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        pending[job] = (src, lib, tmp, proc, time.perf_counter())
    for job, (src, lib, tmp, proc, t0) in pending.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name} "
                               f"({proc.returncode}):\n{log}")
        os.replace(tmp, lib)
        lib.with_suffix(".log").write_text(log)
        out[job] = (lib, time.perf_counter() - t0, log)
    return out


class KernelLibrary:
    """One kernel body's shared library for one network shape, built and
    loaded at first use.

    ``name`` and ``argtypes`` declare its C entry point, which launches on
    the stream it is given and returns ``cudaGetLastError()``; a call
    raises ``RuntimeError`` when that is not 0.  A negative return is the
    entry point's refusal of inputs that need more shared memory a block
    than the card has (minus the bytes) and raises ``ValueError``.
    ``widths`` are the hidden widths the library is built for;
    :meth:`at` gives the body's library for other widths (one instance a
    shape, each with its own loaded function).  Loading checks that the
    library reports those widths.
    """

    def __init__(self, source: str, name: str, argtypes: list,
                 widths=CANONICAL_WIDTHS):
        self.source = CSRC / source
        self.name = name
        self.argtypes = argtypes
        self.widths = tuple(int(w) for w in widths)
        self._fn = None
        self._shapes = {self.widths: self}

    def at(self, widths) -> "KernelLibrary":
        """This body's library for a network of hidden ``widths``."""
        widths = tuple(int(w) for w in widths)
        lib = self._shapes.get(widths)
        if lib is None:
            lib = KernelLibrary(self.source.name, self.name, self.argtypes,
                                widths)
            lib._shapes = self._shapes
            self._shapes[widths] = lib
        return lib

    def build(self) -> Path:
        job = (self.source, self.widths)
        return build_all([job])[job][0]

    def __call__(self, *args) -> None:
        if self._fn is None:
            dll = ctypes.CDLL(str(self.build()))
            got = (ctypes.c_int * 64)()
            n = dll.cude_hidden_widths(got, 64)
            if tuple(got[:n]) != self.widths:
                raise RuntimeError(f"{self.name}: the library was built for "
                                   f"widths {tuple(got[:n])}, not "
                                   f"{self.widths}")
            fn = getattr(dll, self.name)
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


def count_launch(shape_launches: dict, net) -> None:
    """Adds one to a wrapper's ``shape_launches``, ``{(input_dims, hidden
    widths): launches}``, for a launch of the body for ``net``."""
    shape = (net.input_dims, tuple(net.widths))
    shape_launches[shape] = shape_launches.get(shape, 0) + 1


def launch_total(shape_launches: dict, name: str, module: str) -> int:
    """A wrapper module's ``launches`` (its 2-input body's launches at
    every shape) or ``launches_age`` (its 3-input body's), summed from its
    ``shape_launches``; the modules' ``__getattr__``."""
    inputs = {"launches": 2, "launches_age": 3}.get(name)
    if inputs is None:
        raise AttributeError(f"module {module!r} has no attribute {name!r}")
    return sum(n for (d, _), n in shape_launches.items() if d == inputs)


VP, I64, I32, F32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                     ctypes.c_float)
F32_PTR = ctypes.POINTER(ctypes.c_float)
