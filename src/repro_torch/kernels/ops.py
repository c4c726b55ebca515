"""Kernel dispatch, the CUDA loader and the launch counters.

Dispatch rule, shared by every kernel wrapper: a tensor on the CPU gets the
kernel's plain PyTorch version; a tensor on a CUDA card gets the
hand-written kernel, or an exception.  There is no fallback: a kernel that
fails to build or launch raises.

The kernels are CUDA C++ for ``sm_90a`` under ``repro_torch/csrc``.  Each
source is compiled by ``nvcc`` into a shared library with a plain C
interface at first use (one ``nvcc`` process per source, all started
together) into ``csrc/_build`` — named by the source's content hash, so an
edited source is rebuilt — and loaded with ``ctypes``.

``LAUNCHES`` counts kernel launches by name; a wrapper adds one where it
launches its kernel and nowhere else, so a run can show that it went
through the kernels.  A CUDA graph capture runs the wrappers without
launching anything: :func:`launches_apart` keeps what they count out of
``LAUNCHES``, and each replay of the graph adds it back once
(:func:`add_launches`, ``serving/graphs.py``).
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Iterable, TypeVar

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = _CSRC / "_build"
SOURCES = ("smooth_quant", "int8_matmul", "int4_matmul", "flash_decode")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: collections.Counter = collections.Counter()
_LIBS: Dict[str, ctypes.CDLL] = {}

T = TypeVar("T")


def launch_counts() -> dict:
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    LAUNCHES.clear()


@contextlib.contextmanager
def launches_apart():
    """Yield a Counter that holds, when the block ends, the launches the
    wrappers counted inside it; ``LAUNCHES`` is left as it was before."""
    before = LAUNCHES.copy()
    counted: collections.Counter = collections.Counter()
    try:
        yield counted
    finally:
        counted.update(LAUNCHES - before)
        LAUNCHES.clear()
        LAUNCHES.update(before)


def add_launches(counts) -> None:
    """Add a replayed graph's launches (recorded by :func:`launches_apart`)."""
    LAUNCHES.update(counts)


def dispatch(x: torch.Tensor, plain: Callable[[], T],
             kernel: Callable[[], T]) -> T:
    """Run ``plain()`` for a CPU tensor, ``kernel()`` for a CUDA tensor."""
    if x.device.type == "cpu":
        return plain()
    if x.device.type == "cuda":
        return kernel()
    raise ValueError(f"no kernel or plain version for device {x.device}")


# ---------------------------------------------------------------------------
# Loader
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels are built "
        f"from {_CSRC} at first use and need the CUDA toolkit")


def library_path(name: str) -> Path:
    """The library of source ``name``, named by the hash of the source and
    of the headers beside it (which any source may include)."""
    h = hashlib.sha256((_CSRC / f"{name}.cu").read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all started together.  Returns each compiled source's
    ``nvcc``/``ptxas`` report (registers, shared memory, spills); raises
    with the compiler's output if any build fails."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode})\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def _library(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        err = getattr(lib, f"{name}_error_string")
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def c_function(lib_name: str, fn_name: str, argtypes) -> Callable:
    """The C entry point ``fn_name`` of library ``lib_name`` with its
    argument types declared (pointers and the stream as ``c_void_p``)."""
    fn = getattr(_library(lib_name), fn_name)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
    return fn


def check(lib_name: str, err: int) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = getattr(_library(lib_name), f"{lib_name}_error_string")(err)
        raise RuntimeError(f"{lib_name} kernel launch failed: CUDA error "
                           f"{err} ({msg.decode()})")


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


# ---------------------------------------------------------------------------
# Composite dispatch
# ---------------------------------------------------------------------------

def quantize_act(x: torch.Tensor, smooth: torch.Tensor):
    """The quantize half of a quantized linear: x (..., K) → (x̂ int8
    (M, K), Δx f32 (M,)) over its rows, by the ``smooth_quant`` kernel."""
    from repro_torch.kernels.smooth_quant import smooth_quant

    return smooth_quant(x.reshape(-1, x.shape[-1]).contiguous(), smooth)


def w8a8_gemm(xq, dx, w_int8, w_scale, batch_shape, out_dtype) -> torch.Tensor:
    """The GEMM half of the W8A8 linear: x̂ (M, K) int8 and Δx (M,) from
    :func:`quantize_act` or ``norm_smooth_quant`` → (*batch_shape, N)."""
    from repro_torch.kernels.int8_matmul import int8_matmul

    y = int8_matmul(xq, w_int8, dx, w_scale, out_dtype=out_dtype)
    return y.reshape(*batch_shape, w_int8.shape[0])


def w4a8_gemm(xq, dx, w_int4, w_scale, batch_shape, out_dtype) -> torch.Tensor:
    """The GEMM half of the W4A8 linear (packed (N, K/2) weight)."""
    from repro_torch.kernels.int4_matmul import int4_matmul

    y = int4_matmul(xq, w_int4, dx, w_scale, out_dtype=out_dtype)
    return y.reshape(*batch_shape, w_int4.shape[0])


def w8a8_matmul(
    x: torch.Tensor,         # (..., K) activations (bf16/f32)
    w_int8: torch.Tensor,    # (N, K) int8, K contiguous
    w_scale: torch.Tensor,   # (N,) f32
    smooth: torch.Tensor,    # (K,) f32
) -> torch.Tensor:
    """Quantized-verification linear (paper §3.3):
    smooth → quant → int8 GEMM → dequant, in ``x.dtype``."""
    xq, dx = quantize_act(x, smooth)
    return w8a8_gemm(xq, dx, w_int8, w_scale, x.shape[:-1], x.dtype)


def w4a8_matmul(
    x: torch.Tensor,         # (..., K) activations (bf16/f32)
    w_int4: torch.Tensor,    # (N, K/2) int8, two int4 per byte, K contiguous
    w_scale: torch.Tensor,   # (N,) f32
    smooth: torch.Tensor,    # (K,) f32
) -> torch.Tensor:
    """Ultra-low-bit verification linear: smooth → quant → W4A8 GEMM →
    dequant, in ``x.dtype``."""
    xq, dx = quantize_act(x, smooth)
    return w4a8_gemm(xq, dx, w_int4, w_scale, x.shape[:-1], x.dtype)


def w8a8_expert_matmul(
    x: torch.Tensor,         # (E, C, K) dispatched activations (bf16/f32)
    w_int8: torch.Tensor,    # (E, N, K) int8, K contiguous
    w_scale: torch.Tensor,   # (E, N) f32
    smooth: torch.Tensor,    # (K,) f32, shared by the experts
) -> torch.Tensor:
    """The W8A8 expert product of an MoE layer (``repro/models/moe.py``
    ``_expert_linear``): every row smoothed and quantized per token, then
    every expert's int8 GEMM in one ``int8_matmul_batched`` launch →
    (E, C, N) in ``x.dtype``."""
    from repro_torch.kernels.int8_matmul import int8_matmul_batched

    E, C, K = x.shape
    xq, dx = quantize_act(x, smooth)
    return int8_matmul_batched(xq.view(E, C, K), w_int8, dx.view(E, C), w_scale,
                               out_dtype=x.dtype)
