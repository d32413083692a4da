"""Build the hand-written CUDA kernels with ``nvcc`` at first use and load
them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes),
compiled for ``sm_90a`` into ``kernels/build/`` — a directory git ignores.
A library's file name carries a hash of its sources and flags, so an edit
rebuilds it and an unchanged source is loaded as built.  :func:`build`
starts one ``nvcc`` per source, all at once.

Nothing here runs at import: ``nvcc`` exists only on the machine with the
card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
KERNELS = ("ell_spmm", "aes_sample", "fused_spmm", "fused_layer", "dequant",
           "block_ell_spmm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict = {}


def nvcc() -> str:
    """Path of ``nvcc``: on ``$PATH``, else the toolkit's default place."""
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (neither on PATH nor at /usr/local/cuda/bin): "
            "the CUDA kernels are built on the machine with the card")
    return path


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict:
    """Build every library of ``names`` that is not built yet, one ``nvcc``
    process per source, all started together.  Returns the seconds each
    build took (0.0 for one that was already built); raises
    ``RuntimeError`` with the compiler's output when one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs, seconds = {}, {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        # unique temporary name, then an atomic rename: concurrent builders
        # of one library never see a half-written file
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc {name}.cu exited {proc.returncode}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.

    ``signatures`` maps each C function the caller uses to its
    ``argtypes``; every one returns an int (a ``cudaError_t``).
    """
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError``)."""
    if code != 0:
        msg = lib.repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")


def stream_handle(device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device``, for a launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def require(cond: bool, msg: str) -> None:
    """Input validation for the wrappers (kept under ``python -O``)."""
    if not cond:
        raise ValueError(msg)


def require_csr(row_ptr, col_ind, val) -> None:
    """Validate a CSR's arrays for a kernel: int32 row pointers and column
    indices, f32 values, contiguous, and nnz < 2^31 (int32 offsets, as in
    the reference sampler)."""
    require(row_ptr.dim() == 1 and row_ptr.shape[0] >= 1
            and row_ptr.dtype == torch.int32,
            "row_ptr must be int32[rows + 1]")
    require(col_ind.dim() == 1 and col_ind.dtype == torch.int32,
            "col_ind must be int32[nnz]")
    require(val.shape == col_ind.shape and val.dtype == torch.float32,
            "val must be f32 and shaped like col_ind")
    require(col_ind.shape[0] < 2**31, "nnz must be < 2^31")
    for name, t in (("row_ptr", row_ptr), ("col_ind", col_ind),
                    ("val", val)):
        require(t.is_contiguous(), f"{name} must be contiguous")


def route(*tensors: torch.Tensor) -> str:
    """``"cpu"`` or ``"cuda"``: where a wrapper's inputs lie, which picks
    the plain version or the kernel.  Raises on mixed or other devices."""
    devices = {t.device for t in tensors}
    require(len(devices) == 1, f"inputs on several devices: {devices}")
    kind = devices.pop().type
    require(kind in ("cpu", "cuda"),
            f"inputs on a {kind!r} device: the wrapper runs on 'cpu' "
            "(plain version) or 'cuda' (kernel)")
    return kind
