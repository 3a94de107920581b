"""Time the bf16 GEMM of ``csrc/gemm_wide.cuh`` on one card at the Item
Q-Former's products, beside ``torch.matmul`` (cuBLAS, the yardstick for the
product alone; the port does not call it for these products).

    python3 scripts/bench_gemm_wide.py [--iters 50]

Builds one small library from ``gemm_wide.cuh`` (into
``build/bench_gemm_wide/``), checks each launch against the product in fp32
and prints ms and TFLOP/s per shape:

* B12's products at the item-training batch (16,384 rows): x . Wqkv ->
  3072, ctx . Wo (and dout . Wo^T) -> 1024, mem . Wkv [7168, 1024] -> 2048,
  the +bias epilogue, on the TMA kernel and the edge path's kernel;
* the bf16 sweep's four products at 4096 items (131,072 rows), each with
  the epilogue its block takes: x . Wqkv -> 3072 (+bias), ctx . Wo -> 1024
  and h . W2 [131072, 4096] -> 1024 (+bias +residual, fp32 out; and the
  LayerNorm written by the cluster epilogue, bf16 out, with gamma = beta =
  bias), x . W1 -> 4096 (+bias, tanh gelu), on the TMA kernel.

Needs a card and nvcc; prints the card's name and power limit first.
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
TMA = "TMA + wgmma (gemm_tma_kernel)"
LN = "TMA + wgmma, LayerNorm over a cluster (gemm_tma_kernel)"
B12_CFGS = {
    TMA: "launch_gemm_tma<bf16, WG_BIAS, 256, false>",
    "4-byte cp.async + wgmma (gemm_edge_kernel)":
        "launch_gemm_edge<bf16, WG_BIAS, false>",
}
B12_SHAPES = ((16384, 3072, 1024), (16384, 1024, 1024), (7168, 2048, 1024))
# the bf16 sweep's products at 4096 items: (label, m, n, k, epilogue)
SWEEP_SHAPES = (("x . Wqkv^T", 131072, 3072, 1024, "bias"),
                ("ctx . Wo^T", 131072, 1024, 1024, "bias_resid"),
                ("x . W1^T", 131072, 4096, 1024, "bias_gelu"),
                ("h . W2^T", 131072, 1024, 4096, "bias_resid"))
WG_EPI = {"bias": "WG_BIAS", "bias_gelu": "WG_BIAS_GELU",
          "bias_resid": "WG_BIAS_RESID"}


def build(launches: dict) -> list:
    """A library of ``gemm_wide.cuh`` with one C entry per launch (label ->
    the text of a call over a, w, b, r, c, m, n, k, s); the entries."""
    out = ROOT / "build" / "bench_gemm_wide"
    out.mkdir(parents=True, exist_ok=True)
    unit = ['#include "gemm_wide.cuh"']
    for i, launch in enumerate(launches.values()):
        unit.append(
            f'extern "C" int bench_gemm_{i}(const void* a, const void* w, '
            'const float* b, const void* r, void* c, int m, int n, int k, '
            'void* s) {\n'
            f'  return (int){launch};\n}}')
    src = out / "bench.cu"
    src.write_text("\n".join(unit) + "\n")
    lib = out / "libbench.so"
    subprocess.run(["nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
                    "-Xptxas", "-v", "-I", str(CSRC), "-o", str(lib), str(src)],
                   check=True)
    raw = ctypes.CDLL(str(lib))
    for i in range(len(launches)):
        fn = getattr(raw, f"bench_gemm_{i}")
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
    return [getattr(raw, f"bench_gemm_{i}") for i in range(len(launches))]


def wide_launch(launch: str) -> str:
    """``launch`` (a gemm_wide.cuh launcher) with its WgEpi built inline."""
    return (f"{launch}(a, w, [&] {{ WgEpi e{{}}; e.bias = b; "
            "e.resid = static_cast<const bf16*>(r); return e; }(), c, m, n, "
            "k, static_cast<cudaStream_t>(s))")


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


def gelu_tanh(x):
    return x * (0.5 * (1.0 + torch.tanh(0.7978845608028654
                                        * (x + 0.044715 * x ** 3))))


def run_shape(label, m, n, k, variants, gen, iters):
    """Check and time each of ``variants`` (label -> (C entry, epilogue)) at
    one shape beside ``torch.matmul``."""
    a = torch.randn(m, k, device="cuda", generator=gen).bfloat16()
    w = (torch.randn(n, k, device="cuda", generator=gen) * 0.03).bfloat16()
    bias = torch.randn(n, device="cuda", generator=gen) * 0.1
    resid = torch.randn(m, n, device="cuda", generator=gen).bfloat16()
    flop = 2.0 * m * n * k
    t = time_ms(lambda: torch.matmul(a, w.t()), iters)
    print(f"{label} [{m}, {k}] -> {n}: torch.matmul {t:.4f} ms, "
          f"{flop / t / 1e9:.1f} TFLOP/s", flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    for cfg, (fn, epi) in variants.items():
        ref = a.float() @ w.float().t() + bias
        if epi == "bias_gelu":
            ref = gelu_tanh(ref)
        elif epi.startswith("bias_resid"):
            ref += resid.float()
        if epi == "bias_resid_ln":
            mu = ref.mean(-1, keepdim=True)
            var = ((ref - mu) ** 2).mean(-1, keepdim=True)
            ref = (ref - mu) * torch.rsqrt(var + 1e-12) * bias + bias
        dtype = torch.float32 if epi == "bias_resid" else torch.bfloat16
        c = torch.empty(m, n, device="cuda", dtype=dtype)
        call = lambda: fn(a.data_ptr(), w.data_ptr(), bias.data_ptr(),  # noqa: E731
                          resid.data_ptr(), c.data_ptr(), m, n, k, stream)
        err = call()
        torch.cuda.synchronize()
        rel = ((c.float() - ref).abs().max() / ref.abs().max()).item()
        t = time_ms(call, iters)
        print(f"    {cfg} ({epi}): rc {err}, rel {rel:.2e}, {t:.4f} ms, "
              f"{flop / t / 1e9:.1f} TFLOP/s", flush=True)
        del c, ref
    del a, w, bias, resid
    torch.cuda.empty_cache()


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
    wide = {f"{cfg} {epi}": wide_launch(launch.replace("WG_BIAS", WG_EPI[epi]))
            for cfg, launch in B12_CFGS.items() for epi in WG_EPI
            if cfg == TMA or epi == "bias"}
    wide[LN] = ("gemm_resid_ln(a, w, b, r, b, b, 1e-12f, c, m, n, k, "
                "static_cast<cudaStream_t>(s))")
    fns = dict(zip(wide, build(wide)))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for m, n, k in B12_SHAPES:
        run_shape("B12", m, n, k,
                  {cfg: (fns[f"{cfg} bias"], "bias") for cfg in B12_CFGS},
                  gen, args.iters)
    for label, m, n, k, epi in SWEEP_SHAPES:
        variants = {TMA: (fns[f"{TMA} {epi}"], epi)}
        if epi == "bias_resid":
            variants[LN] = (fns[LN], "bias_resid_ln")
        run_shape(label, m, n, k, variants, gen, args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
