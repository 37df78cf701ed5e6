"""Build and load the port's CUDA kernels.

The ``csrc/*.cu`` sources are compiled by ``nvcc`` by hand (one process
per source, all started together) into one shared library with a plain C
interface, which is loaded with :mod:`ctypes`.  Nothing includes
PyTorch's headers, so a cold build takes seconds, not minutes.

The library lands in ``build/repro_torch_kernels/<hash>/`` at the root
of the checkout, keyed by a hash of the sources and flags, and is built
at first use: the first CUDA launch of any wrapper builds it.  A missing
``nvcc`` or a failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = tuple(CSRC / name for name in
                ("census_fused.cu", "pair_codes.cu", "tricode_hist.cu"))
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
LIB_NAME = "librepro_torch_kernels.so"
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C signature of every entry point: (argtypes, restype)
SIGNATURES = {
    "census_fused_desc_launch": ([_P] * 11 + [_I] * 4 + [_P, _P], _I),
    "census_fused_desc_probe_launch": ([_P] * 11 + [_I] * 4 + [_P] * 4,
                                       _I),
    "census_fused_desc_batch_launch": ([_P] * 7 + [_I] * 6 + [_P, _P], _I),
    "census_fused_desc_occupancy": ([_P], _I),
    "census_fused_items_launch": ([_P] * 7 + [_I] + [_P, _P], _I),
    "census_fused_items_probe_launch": ([_P] * 7 + [_I] + [_P] * 5, _I),
    "tricode_hist_launch": ([_P, _P, _I, _P, _P], _I),
    "pair_codes_launch": ([_P, _P, _P, _I, _P, _P], _I),
    "desc_anchors_launch": ([_P, _I, _P, _I, _P], _I),
    "repro_torch_error_string": ([_I], ctypes.c_char_p),
}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default
    location.  Raises if neither exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    if DEFAULT_NVCC.exists():
        return str(DEFAULT_NVCC)
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
        "of repro_torch are built from source at first use")


def library_path(sources: tuple[Path, ...] = SOURCES) -> Path:
    """Where the library for these sources and the flags lives."""
    digest = hashlib.sha256()
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / digest.hexdigest()[:16] / LIB_NAME


def build(sources: tuple[Path, ...] = SOURCES) -> Path:
    """Compile the kernels unless the library for these sources exists.

    ``sources`` are the package's own unless a measurement swaps in
    another version of one of them (same file name, same C interface).
    Returns the library path; the compiler's output (``-Xptxas -v``:
    registers, shared memory and spills per kernel) is kept beside it in
    ``build.log``.
    """
    lib = library_path(sources)
    if lib.exists():
        return lib
    nvcc = nvcc_path()
    lib.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in sources]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objs)]
        logs = [p.communicate()[0] for p in procs]
        for src, p, log in zip(sources, procs, logs):
            if p.returncode:
                raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        staged = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(staged), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (lib.parent / "build.log").write_text("".join(logs) + link.stdout)
        os.replace(staged, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load_library(sources: tuple[Path, ...] = SOURCES) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every entry
    point's ``argtypes``/``restype`` declared (a library built from
    other versions of the sources may lack some)."""
    lib = ctypes.CDLL(str(build(sources)))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is None and sources == SOURCES:
            raise RuntimeError(f"the kernel library lacks {name}")
        if fn is not None:  # another version of a source may lack it
            fn.argtypes = argtypes
            fn.restype = restype
    return lib


def require_vector(name: str, t, device, length: int | None = None) -> int:
    """Check that ``t`` is a contiguous 1-D int32 tensor on ``device``
    (and ``length`` long when given); return its data pointer."""
    import torch
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D tensor, got "
                         f"shape {tuple(t.shape)}")
    if length is not None and t.shape[0] != length:
        raise ValueError(f"{name} has length {t.shape[0]}, expected "
                         f"{length}")
    if t.shape[0] >= 2**31:
        raise ValueError(f"{name} exceeds int32 indexing")
    return t.data_ptr()


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch entry point returned a CUDA error."""
    if err:
        msg = lib.repro_torch_error_string(err).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {err} "
                           f"({msg})")
