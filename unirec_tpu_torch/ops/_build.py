"""Build and load the port's hand-written CUDA kernels.

The ``.cu`` sources under ``unirec_tpu_torch/csrc/`` expose a plain C
interface.  On first use each source is compiled by its own ``nvcc`` process
for ``sm_90a`` (all started together), and the objects are linked into one
shared library and loaded with ``ctypes``.  The library goes to the directory
that ``UNIREC_TPU_TORCH_BUILD_DIR`` names, or by default to
``build/unirec_tpu_torch/`` at the repository root (a directory ``.gitignore``
lists).  Its file name carries a hash of the sources and the headers they
include (``csrc/*.cuh``), so an edited source is rebuilt.

Nothing here runs at import time: the CPU tests import every module of the
port on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("flash_causal_fwd.cu", "flash_causal_bwd.cu", "retrieve_topk.cu",
           "qformer_blocks.cu", "fused_qformer_vjp.cu", "flash_cross.cu",
           "packed_attention.cu")
HEADERS = ("attention_f32.cuh", "causal_tiles.cuh", "flash_chunked.cuh",
           "flash_chunked_cluster.cuh", "gemm_f32.cuh", "gemm_wide.cuh", "head_dim.cuh",
           "item_attention.cuh", "ptx_helpers.cuh")
BUILD_DIR_ENV = "UNIREC_TPU_TORCH_BUILD_DIR"
DEFAULT_BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
                     / "unirec_tpu_torch")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong


@dataclass
class Kernels:
    """The loaded library with its build record."""

    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an existing build was reused
    ptxas_log: str


def build_dir() -> Path:
    """Where the library is built: ``$UNIREC_TPU_TORCH_BUILD_DIR`` when set
    (an installed package may not be able to write beside itself), else
    ``build/unirec_tpu_torch`` at the repository root."""
    override = os.environ.get(BUILD_DIR_ENV)
    return Path(override).expanduser().resolve() if override else DEFAULT_BUILD_DIR


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels build only on a machine "
        "with the CUDA toolkit"
    )


@functools.lru_cache(maxsize=None)
def load_kernels() -> Kernels:
    """Compile (if needed) and load the kernel library; cached per process."""
    srcs = [CSRC / name for name in SOURCES]
    digest = hashlib.sha256()
    for path in srcs + [CSRC / name for name in HEADERS]:
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out = build_dir() / f"libunirec_kernels_{digest.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        t0 = time.perf_counter()
        log = _compile(srcs, out)
        seconds = time.perf_counter() - t0
    lib = bind(ctypes.CDLL(str(out)))
    return Kernels(lib, out, seconds, log)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entries' argument and result types on ``lib``."""
    lib.unirec_flash_causal_fwd.argtypes = [_P] * 8 + [_I] * 7 + [_F, _P]
    lib.unirec_flash_causal_fwd.restype = _I
    lib.unirec_flash_causal_bwd_dq.argtypes = [_P] * 10 + [_I] * 7 + [_F, _P]
    lib.unirec_flash_causal_bwd_dq.restype = _I
    lib.unirec_flash_causal_bwd_dkv.argtypes = [_P] * 10 + [_I] * 6 + [_F, _P]
    lib.unirec_flash_causal_bwd_dkv.restype = _I
    lib.unirec_chunked_form.argtypes = [_I] * 3
    lib.unirec_chunked_form.restype = _I
    lib.unirec_retrieve_topk.argtypes = [_P] * 6 + [_I] * 9 + [_P]
    lib.unirec_retrieve_topk.restype = _I
    lib.unirec_qformer_self_block.argtypes = [_P] * 11 + [_I] * 4 + [_F, _F, _P]
    lib.unirec_qformer_self_block.restype = _I
    lib.unirec_qformer_cross_block.argtypes = ([_P] * 16 + [_I] * 6
                                               + [_F, _F, _P])
    lib.unirec_qformer_cross_block.restype = _I
    lib.unirec_qformer_ffn_block.argtypes = [_P] * 10 + [_I] * 3 + [_F, _P]
    lib.unirec_qformer_ffn_block.restype = _I
    lib.unirec_qformer_self_block_f32.argtypes = [_P] * 11 + [_I] * 4 + [
        _F, _F, _P]
    lib.unirec_qformer_self_block_f32.restype = _I
    lib.unirec_qformer_cross_block_f32.argtypes = ([_P] * 16 + [_I] * 6
                                                   + [_F, _F, _P])
    lib.unirec_qformer_cross_block_f32.restype = _I
    lib.unirec_qformer_ffn_block_f32.argtypes = [_P] * 10 + [_I] * 3 + [_F,
                                                                        _P]
    lib.unirec_qformer_ffn_block_f32.restype = _I
    lib.unirec_retrieve_topk_int8.argtypes = [_P] * 7 + [_I] * 8 + [_P]
    lib.unirec_retrieve_topk_int8.restype = _I
    lib.unirec_qformer_self_block_q.argtypes = [_P] * 15 + [_I] * 5 + [_F, _F,
                                                                      _P]
    lib.unirec_qformer_self_block_q.restype = _I
    lib.unirec_qformer_cross_block_q.argtypes = ([_P] * 23 + [_I] * 7
                                                 + [_F, _F, _P])
    lib.unirec_qformer_cross_block_q.restype = _I
    lib.unirec_qformer_ffn_block_q.argtypes = [_P] * 16 + [_I] * 5 + [_F, _P]
    lib.unirec_qformer_ffn_block_q.restype = _I
    lib.unirec_gemm_q_test.argtypes = [_I] + [_P] * 3 + [_I] + [_P] * 5 + [
        _I] * 4 + [_P]
    lib.unirec_gemm_q_test.restype = _I
    lib.unirec_gemm_ln_test.argtypes = [_I] + [_P] * 8 + [_I] * 3 + [_F, _P]
    lib.unirec_gemm_ln_test.restype = _I
    lib.unirec_resid_ln_two_pass.argtypes = [_I, _I]
    lib.unirec_resid_ln_two_pass.restype = _I
    lib.unirec_int8_linear.argtypes = [_P] * 6 + [_I] * 3 + [_P]
    lib.unirec_int8_linear.restype = _I
    lib.unirec_int8_linear_f32.argtypes = [_P] * 6 + [_I] * 3 + [_P]
    lib.unirec_int8_linear_f32.restype = _I
    lib.unirec_qwen3_swiglu_q.argtypes = [_P] * 11 + [_I] * 3 + [_P]
    lib.unirec_qwen3_swiglu_q.restype = _I
    lib.unirec_b12_self_fwd.argtypes = [_P] * 9 + [_I] * 4 + [_F, _P]
    lib.unirec_b12_self_fwd.restype = _I
    lib.unirec_b12_self_bwd.argtypes = [_P] * 6 + [_I] * 4 + [_F, _P]
    lib.unirec_b12_self_bwd.restype = _I
    lib.unirec_b12_cross_fwd.argtypes = [_P] * 13 + [_I] * 6 + [_F, _P]
    lib.unirec_b12_cross_fwd.restype = _I
    lib.unirec_b12_cross_bwd.argtypes = [_P] * 8 + [_I] * 5 + [_F, _P]
    lib.unirec_b12_cross_bwd.restype = _I
    lib.unirec_b12_self_fwd_f32.argtypes = [_P] * 9 + [_I] * 4 + [_F, _P]
    lib.unirec_b12_self_fwd_f32.restype = _I
    lib.unirec_b12_self_bwd_f32.argtypes = [_P] * 7 + [_I] * 4 + [_F, _P]
    lib.unirec_b12_self_bwd_f32.restype = _I
    lib.unirec_b12_cross_fwd_f32.argtypes = [_P] * 13 + [_I] * 6 + [_F, _P]
    lib.unirec_b12_cross_fwd_f32.restype = _I
    lib.unirec_b12_cross_bwd_f32.argtypes = [_P] * 9 + [_I] * 5 + [_F, _P]
    lib.unirec_b12_cross_bwd_f32.restype = _I
    lib.unirec_flash_cross_fwd.argtypes = [_P] * 8 + [_L] * 12 + [_I] * 7 + [
        _F, _P]
    lib.unirec_flash_cross_fwd.restype = _I
    lib.unirec_flash_cross_bwd.argtypes = [_P] * 14 + [_I] * 7 + [_F, _P]
    lib.unirec_flash_cross_bwd.restype = _I
    lib.unirec_packed_item_attention.argtypes = [_P] * 5 + [_L] * 12 + [
        _I] * 6 + [_F, _P]
    lib.unirec_packed_item_attention.restype = _I
    return lib


def _compile(srcs, out: Path) -> str:
    """One ``nvcc -c`` per source, all started together, then one link;
    returns the compilers' output (``-Xptxas -v``)."""
    nvcc = _nvcc()
    work = out.parent / f"{out.stem}.{os.getpid()}.objs"
    work.mkdir(parents=True, exist_ok=True)
    objs = [work / f"{src.stem}.o" for src in srcs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for src, obj in zip(srcs, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    log = "".join(logs)
    failed = [src.name for src, proc in zip(srcs, procs) if proc.returncode]
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    shutil.rmtree(work, ignore_errors=True)
    return log


def check(err: int, name: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with cudaError_t {err}")
