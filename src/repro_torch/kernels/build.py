"""Build and load the hand-written Hopper kernels.

Each CUDA source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface and loaded with ``ctypes``.
All sources build at once, one ``nvcc`` process each, into
``build/repro_torch_kernels/`` at the root of the checkout; a library is
named by the content hash of its source and of the headers beside it
(``limb_core.cuh``), so an edited source or header rebuilds and an
unchanged one loads as it is.  The compiler's log (ptxas register and
shared-memory use, its notes) is kept beside each library under the same
name.  Nothing here runs at import: the CPU tests import every module of
the package.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
SOURCES = ("prf_mask", "ring_matmul", "gamma_parts", "and_level",
           "mpc_matmul_fused")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_U64 = ctypes.c_uint64
# C entry points and their argument types (the stream comes last).
SIGNATURES = {
    "prf_mask_group_u64": (_P, _P, _P),     # out, address of a PrfGroup
    "prf_mask_group_u32": (_P, _P, _P),
    "ring_matmul_u64": (_P, _P, _P, _I, _I, _I, _I, _P),
    "ring_matmul_u32": (_P, _P, _P, _I, _I, _I, _I, _P),
    # A, B, C, batch, M, N, K, k_chunk, A and B batch strides (words)
    "ring_matmul_batched_u64": (_P, _P, _P, _I, _I, _I, _I, _I, _I64, _I64,
                                _P),
    "ring_matmul_batched_u32": (_P, _P, _P, _I, _I, _I, _I, _I, _I64, _I64,
                                _P),
    # address of a TermLaunch (the grouped gamma-piece kernel)
    "mult_terms_group_u64": (_P, _P),
    "mult_terms_group_u32": (_P, _P),
    "and_terms_group_u64": (_P, _P),
    "and_terms_group_u32": (_P, _P),
    "and_level_u64": (_P, _P, _P, _P, _P, _I64, _P),
    "and_level_u32": (_P, _P, _P, _P, _P, _I64, _P),
    # x, y, draws, streams an AND, cin, out, n
    "ppa_add_u64": (_P, _P, _P, _I, _I, _P, _I64, _P),
    "ppa_add_u32": (_P, _P, _P, _I, _I, _P, _I64, _P),
    # x, draws, streams an AND, NOT's mask, out, n
    "prefix_or_u64": (_P, _P, _I, _U64, _P, _I64, _P),
    "prefix_or_u32": (_P, _P, _I, _U64, _P, _I64, _P),
    # x, y, lamz levels, zero levels, out, n
    "ppa_msb_u64": (_P, _P, _P, _P, _P, _I64, _P),
    "ppa_msb_u32": (_P, _P, _P, _P, _P, _I64, _P),
    # kind, x, y, draws, streams an AND, arg, gammas, out, n
    "and_chain_offline_u64": (_I, _P, _P, _P, _I, _U64, _P, _P, _I64, _P),
    "and_chain_offline_u32": (_I, _P, _P, _P, _I, _U64, _P, _P, _I64, _P),
    # kind, x, y, lamz, gammas, arg, out, n
    "and_chain_online_u64": (_I, _P, _P, _P, _P, _U64, _P, _I64, _P),
    "and_chain_online_u32": (_I, _P, _P, _P, _P, _U64, _P, _I64, _P),
    "mpc_matmul_fused_u64": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "mpc_matmul_fused_u32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
}

_LIBS: dict = {}
# a pipelined server's dealer thread and its consumer may load the first
# library at once
_LOAD_LOCK = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build "
                           "the Hopper kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _target(name: str) -> Path:
    text = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _log(name: str) -> Path:
    return _target(name).with_suffix(".log")


def build_all() -> None:
    """Compile every source that has no library (or no log) yet, all in
    parallel; raise if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in SOURCES
            if not (_target(n).exists() and _log(n).exists())]
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = _target(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            continue
        _log(name).write_text(log)
        os.replace(tmp, _target(name))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed))


def compile_log(name: str) -> str:
    """The compiler's log of one source's library, built first if need
    be."""
    build_all()
    return _log(name).read_text()


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if need be."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOAD_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if not _target(name).exists():
                build_all()
            lib = ctypes.CDLL(str(_target(name)))
            for sym, argtypes in SIGNATURES.items():
                fn = getattr(lib, sym, None)
                if fn is not None:
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
            _LIBS[name] = lib
    return lib


def launch(source: str, symbol: str, device, *args) -> None:
    """Call one C entry point on the current stream of `device` (a
    ``torch.device``); raise if the launch was refused (the C side returns
    ``cudaGetLastError()``).  The stream comes as a raw handle, and the
    device is switched only when it is not the current one: both cost
    microseconds of host time a launch."""
    import torch
    fn = getattr(library(source), symbol)
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == current:
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            rc = fn(*args, stream)
    if rc:
        raise RuntimeError(f"{symbol}: CUDA error {rc} at launch")


def check_operands(*tensors, contiguous: bool = True) -> None:
    """The kernels take (contiguous, unless `contiguous` is False) ring
    words of one type on one CUDA device; anything else is refused before
    a pointer is passed."""
    first = tensors[0]
    if first.device.type != "cuda":
        raise ValueError(f"kernel operands must be CUDA tensors, got "
                         f"{first.device}")
    for t in tensors:
        if t.device != first.device or t.dtype != first.dtype:
            raise ValueError("kernel operands differ in device or dtype: "
                             f"{t.device}/{t.dtype} vs "
                             f"{first.device}/{first.dtype}")
        if contiguous and not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
