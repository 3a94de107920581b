"""Time the B12 projection GEMM (``csrc/gemm_wide.cuh``) on
one card at the item-training products, beside ``torch.matmul`` (cuBLAS, the
yardstick; the port does not call it for these products).

    python3 scripts/bench_gemm_wide.py [--iters 50]

Builds one small library from ``gemm_wide.cuh`` with its two kernels (the
TMA one and the edge path's, into ``build/bench_gemm_wide/``), checks each
against ``torch.matmul`` in fp32 and prints ms and TFLOP/s per shape: x .
Wqkv [16384, 1024] -> 3072, ctx . Wo (and dout . Wo^T) -> 1024, mem . Wkv
[7168, 1024] -> 2048, bf16 with the +bias epilogue.  Needs a card and nvcc;
prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "unirec_tpu_torch" / "csrc"
# label -> the launch (the port's gemm_wide takes the TMA kernel for these
# aligned shapes, and the edge kernel for rows TMA cannot take)
CFGS = {
    "TMA + wgmma (gemm_tma_kernel)": "launch_gemm_tma<bf16, WG_BIAS, 256, false>",
    "4-byte cp.async + wgmma (gemm_edge_kernel)":
        "launch_gemm_edge<bf16, WG_BIAS, false>",
}
SHAPES = ((16384, 3072, 1024), (16384, 1024, 1024), (7168, 2048, 1024))


def build() -> ctypes.CDLL:
    out = ROOT / "build" / "bench_gemm_wide"
    out.mkdir(parents=True, exist_ok=True)
    unit = ['#include "gemm_wide.cuh"']
    for i, launch in enumerate(CFGS.values()):
        unit.append(
            f'extern "C" int bench_gemm_{i}(const void* a, const void* w, '
            'const float* b, void* c, int m, int n, int k, void* s) {\n'
            '  WgEpi e{};\n  e.bias = b;\n'
            f'  return (int){launch}(a, w, e, c, m, n, k, '
            'static_cast<cudaStream_t>(s));\n}')
    src = out / "bench.cu"
    src.write_text("\n".join(unit) + "\n")
    lib = out / "libbench.so"
    subprocess.run(["nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
                    "-Xptxas", "-v", "-I", str(CSRC), "-o", str(lib), str(src)],
                   check=True)
    raw = ctypes.CDLL(str(lib))
    for i in range(len(CFGS)):
        fn = getattr(raw, f"bench_gemm_{i}")
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return raw


def time_ms(fn, iters):
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=50)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("bench_gemm_wide: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    raw = build()
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    for m, n, k in SHAPES:
        a = torch.randn(m, k, device="cuda", generator=gen).bfloat16()
        w = (torch.randn(n, k, device="cuda", generator=gen) * 0.03).bfloat16()
        bias = torch.randn(n, device="cuda", generator=gen) * 0.1
        ref = (a.float() @ w.float().t() + bias)
        flop = 2.0 * m * n * k
        t = time_ms(lambda: torch.matmul(a, w.t()), args.iters)
        print(f"[{m}, {k}] -> {n}: torch.matmul {t:.4f} ms, "
              f"{flop / t / 1e9:.1f} TFLOP/s", flush=True)
        for i, cfg in enumerate(CFGS):
            c = torch.empty(m, n, device="cuda", dtype=torch.bfloat16)
            fn = getattr(raw, f"bench_gemm_{i}")
            call = lambda: fn(a.data_ptr(), w.data_ptr(), bias.data_ptr(),  # noqa: E731
                              c.data_ptr(), m, n, k, stream)
            err = call()
            torch.cuda.synchronize()
            rel = ((c.float() - ref).abs().max() / ref.abs().max()).item()
            t = time_ms(call, args.iters)
            print(f"    {cfg}: rc {err}, rel {rel:.2e}, {t:.4f} ms, "
                  f"{flop / t / 1e9:.1f} TFLOP/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
