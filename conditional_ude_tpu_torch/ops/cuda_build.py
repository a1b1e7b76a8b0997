"""Build and bind the port's CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface.  ``nvcc``
compiles it for ``sm_90a`` at first use into ``build/`` at the repository
root, one library for each network shape and grid kind it is called for:
the hidden widths are compile-time constants of ``csrc/cude_mlp.cuh``
(``CUDE_WIDTHS``, the canonical ``4, 4`` unless a generated header in
``build/`` defines another list; nvcc splits a ``-D`` value at its commas),
and a grid of more than ``SHORT_GRID`` points takes the library built with
``CUDE_LONG_GRID`` (in the same header), which reads the grid's tables from
device memory (:func:`device_table`) where a short grid's are kernel
parameters.  A library's name hashes the source, the shared ``csrc/*.cuh``
headers, the flags, the widths and the grid kind, so an edited kernel
rebuilds itself.  The library is loaded with ``ctypes``.  Nothing here runs
when a module is imported.
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
# points of the longest grid whose tables a kernel takes as parameters
# (``kMaxTimepoints`` in ``csrc/cude_mlp.cuh``); a longer grid takes the
# library built with ``CUDE_LONG_GRID``
SHORT_GRID = 16


def long_grid(timepoints) -> bool:
    """Whether a grid of these ``timepoints`` takes the long-grid library."""
    return len(timepoints) > SHORT_GRID


def widths_tag(widths, long: bool = False) -> str:
    """``"8_8"`` for hidden widths ``(8, 8)``, ``"8_8_long"`` for the
    long-grid build: a file-name part."""
    return "_".join(str(int(w)) for w in widths) + ("_long" if long else "")


def widths_header(widths, long: bool = False) -> Path:
    """The generated header that defines ``CUDE_WIDTHS`` for a network of
    these hidden widths, and ``CUDE_LONG_GRID`` for the long-grid build
    (written by :func:`build_all`)."""
    return BUILD_DIR / f"cude_widths_{widths_tag(widths, long)}.h"


def _canonical(widths, long: bool) -> bool:
    return tuple(widths) == CANONICAL_WIDTHS and not long


def nvcc_command(source: Path, output: Path, widths=CANONICAL_WIDTHS,
                 long: bool = False) -> list[str]:
    """The ``nvcc`` command line that builds ``source`` into ``output`` for
    a network of hidden ``widths`` and the short or long grid; the
    canonical ``(4, 4)`` on a short grid is the headers' own default and
    adds nothing."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = "nvcc" if CUDA_HOME is None else str(Path(CUDA_HOME) / "bin" / "nvcc")
    shape = ([] if _canonical(widths, long)
             else ["-include", str(widths_header(widths, long))])
    return [nvcc, *NVCC_FLAGS, *shape, "-o", str(output), str(source)]


def library_path(source: Path, widths=CANONICAL_WIDTHS,
                 long: bool = False) -> Path:
    key = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        key.update(header.read_bytes())
    key.update(" ".join(NVCC_FLAGS).encode())
    name = source.stem
    if tuple(widths) != CANONICAL_WIDTHS:
        key.update(f"CUDE_WIDTHS {tuple(widths)}".encode())
        name += f"-w{widths_tag(widths)}"
    if long:
        key.update(b"CUDE_LONG_GRID 1")
        name += "-long"
    return BUILD_DIR / f"{name}-{key.hexdigest()[:16]}.so"


def build_all(jobs: list[tuple]) -> dict:
    """Build every ``(source, hidden widths)`` or ``(source, hidden
    widths, long grid)`` job that has no library yet, one ``nvcc`` each,
    all started together.  Returns ``{job: (library, seconds, log)}``;
    ``log`` is what ``nvcc`` printed (ptxas registers and spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pending, out = {}, {}
    for job in jobs:
        src, widths, long = (*job, False)[:3]
        lib = library_path(src, widths, long)
        if lib.exists():
            log = lib.with_suffix(".log")
            out[job] = (lib, 0.0, log.read_text() if log.exists() else "")
            continue
        if not _canonical(widths, long):
            header = widths_header(widths, long)
            text = ("#define CUDE_WIDTHS "
                    + ", ".join(str(int(w)) for w in widths) + "\n"
                    + ("#define CUDE_LONG_GRID 1\n" if long else ""))
            if not header.exists() or header.read_text() != text:
                tmp_h = header.with_suffix(f".{os.getpid()}.tmp")
                tmp_h.write_text(text)
                os.replace(tmp_h, header)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp.so")
        proc = subprocess.Popen(nvcc_command(src, tmp, widths, long),
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
    """One kernel body's shared library for one network shape and grid
    kind, built and loaded at first use.

    ``name`` and ``argtypes`` declare its C entry point, which launches on
    the stream it is given and returns ``cudaGetLastError()``; a call
    raises ``RuntimeError`` when that is not 0.  A negative return is the
    entry point's refusal of inputs that need more shared memory a block
    than the card has (minus the bytes) and raises ``ValueError``.
    ``widths`` are the hidden widths the library is built for and ``long``
    whether it is the long-grid build; :meth:`at` gives the body's library
    for other widths or grid kind (one instance each, each with its own
    loaded function), :meth:`symbol` another entry point of the same
    library.  Loading checks that the library reports those widths and that
    grid kind.
    """

    def __init__(self, source: str, name: str, argtypes: list,
                 widths=CANONICAL_WIDTHS, long: bool = False):
        self.source = CSRC / source
        self.name = name
        self.argtypes = argtypes
        self.widths = tuple(int(w) for w in widths)
        self.long = bool(long)
        self._dll = None
        self._fn = None
        self._symbols = {}
        self._shapes = {(self.widths, self.long): self}

    def at(self, widths, long: bool = False) -> "KernelLibrary":
        """This body's library for a network of hidden ``widths`` and a
        short grid, or with ``long`` a grid of more than ``SHORT_GRID``
        points."""
        key = (tuple(int(w) for w in widths), bool(long))
        lib = self._shapes.get(key)
        if lib is None:
            lib = KernelLibrary(self.source.name, self.name, self.argtypes,
                                *key)
            lib._shapes = self._shapes
            self._shapes[key] = lib
        return lib

    def build(self) -> Path:
        job = (self.source, self.widths, self.long)
        return build_all([job])[job][0]

    def _load(self):
        if self._dll is None:
            dll = ctypes.CDLL(str(self.build()))
            got = (ctypes.c_int * 64)()
            n = dll.cude_hidden_widths(got, 64)
            if tuple(got[:n]) != self.widths:
                raise RuntimeError(f"{self.name}: the library was built for "
                                   f"widths {tuple(got[:n])}, not "
                                   f"{self.widths}")
            if bool(dll.cude_long_grid()) != self.long:
                raise RuntimeError(f"{self.name}: the library was not built "
                                   f"for a {'long' if self.long else 'short'}"
                                   " grid")
            self._dll = dll
        return self._dll

    def symbol(self, name: str, argtypes: list, restype):
        """Another C function of this library (loaded at first use)."""
        fn = self._symbols.get(name)
        if fn is None:
            fn = getattr(self._load(), name)
            fn.argtypes, fn.restype = argtypes, restype
            self._symbols[name] = fn
        return fn

    def workspace(self, device, *args):
        """The device workspace the entry point needs for these sizes, or
        ``None``: ``<name>_workspace(*args)`` of the library (``I64``
        restarts or lanes, then ``I32`` sizes) gives its floats, 0 where
        the kernel's scratch fits shared memory."""
        import torch

        fn = self.symbol(self.name + "_workspace",
                         [I64] + [I32] * (len(args) - 1), I64)
        need = fn(*args)
        if need < 0:
            raise RuntimeError(f"{self.name}: no layout for sizes {args}")
        if need == 0:
            return None
        return torch.empty(need, dtype=torch.float32, device=device)

    def __call__(self, *args) -> None:
        if self._fn is None:
            self._fn = self.symbol(self.name, self.argtypes, ctypes.c_int)
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

# a long grid's host tables copied to each device once:
# {(the array's bytes, device): tensor}
_device_tables: dict = {}


def device_table(host, device):
    """The device address of a copy of the float32 host array ``host`` on
    ``device`` (a long grid's tables, which its kernels read from device
    memory), made at the first call for these values and kept; ``None``
    where ``host`` is ``None``, as for a short grid."""
    if host is None:
        return None
    import numpy as np
    import torch

    slot = (np.asarray(host, np.float32).tobytes(), str(device))
    table = _device_tables.get(slot)
    if table is None:
        table = torch.from_numpy(np.array(host, np.float32)).to(device)
        _device_tables[slot] = table
    return table.data_ptr()
