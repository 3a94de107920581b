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
  bias), x . W1 -> 4096 (+bias, tanh gelu), on the TMA kernel;
* the int8 Qwen3-0.6B serving products at 4096 rows (batch 8 x L 512), on
  the int8 TMA kernel beside ``torch._int_mm`` (cuBLASLt's product alone,
  int32 out): x . Wqkv -> 4096 (B9a), x . Wgu [6144, 1024] (B9b's gate|up),
  h . Wd [4096, 3072] -> 1024 (B9b's down), x . W -> 2048 and ctx . Wo
  [4096, 2048] -> 1024 (B8); the bf16 products with the dequantizing
  epilogue EPQ_PLAIN at block tiles of 128 x 256 and 128 x 128; the gate|up
  product with the SwiGLU epilogue (h in fp32 and its row maxima, what B9b
  runs) and, the alternative measured beside it, to fp32 g|u (EPQ_BIAS_F32
  over a zero bias) followed by one pass for silu and the quantization of h
  (``silu_quant_kernel`` below, the shape of B6's ``gelu_quant``).

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
# the int8 Qwen3 products at 4096 rows: (label, n, k, epilogue)
QWEN_ROWS = 4096
QWEN_SHAPES = (("B9a x . Wqkv^T", 4096, 1024, "plain"),
               ("B9b x . Wgu^T", 6144, 1024, "swiglu"),
               ("B9b h . Wd^T", 1024, 3072, "plain"),
               ("B8 x . W^T", 2048, 1024, "plain"),
               ("B8 ctx . Wo^T", 1024, 2048, "plain"))
# label -> (launch over a, w, e (the WgEpi), c, m, n, k, s; epilogue)
Q_VARIANTS = {
    "TMA + wgmma, 128 x 256 tiles": (
        "launch_gemm_tma<int8_t, EPQ_PLAIN, 256, false>", "plain"),
    "TMA + wgmma, 128 x 128 tiles": (
        "launch_gemm_tma<int8_t, EPQ_PLAIN, 128, false>", "plain"),
    "TMA + wgmma, SwiGLU epilogue (h, row maxima)": (
        "launch_gemm_tma<int8_t, EPQ_SWIGLU, 256, false>", "swiglu"),
    "TMA + wgmma, fp32 g|u (EPQ_BIAS_F32, zero bias)": (
        "launch_gemm_tma<int8_t, EPQ_BIAS_F32, 256, false>", "swiglu_f32"),
}
# the alternative's second pass: one block per row reads g|u [rows, 2I] fp32
# once (16-byte loads), keeps h = (g * sigmoid(g)) * u in registers (I <=
# 4096), takes the row's absmax and writes h's codes and row scale as B9b
# does (absmax * fl(1 / 127))
SILU_QUANT = r"""
constexpr int SQ_THREADS = 256, SQ_MAX = 4096;
__global__ void __launch_bounds__(SQ_THREADS)
silu_quant_kernel(const float* __restrict__ gu, int8_t* __restrict__ q, float* __restrict__ scale,
                  int inter) {
  extern __shared__ float wmax[];  // [SQ_THREADS / 32]
  const size_t row = blockIdx.x;
  const float4* g4 = reinterpret_cast<const float4*>(gu + row * 2 * inter);
  const float4* u4 = g4 + inter / 4;
  uint32_t* qr = reinterpret_cast<uint32_t*>(q + row * inter);
  const int t = threadIdx.x, n4 = inter / 4;
  float h[SQ_MAX / SQ_THREADS];
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < SQ_MAX / SQ_THREADS / 4; ++j) {
    const int c = j * SQ_THREADS + t;
    if (c < n4) {
      const float4 g = g4[c], u = u4[c];
      const float gv[4] = {g.x, g.y, g.z, g.w}, uv[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-gv[i])));
        h[4 * j + i] = __fmul_rn(__fmul_rn(gv[i], sig), uv[i]);
        m = fmaxf(m, fabsf(h[4 * j + i]));
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((t & 31) == 0) wmax[t >> 5] = m;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < SQ_THREADS / 32; ++i) m = fmaxf(m, wmax[i]);
  const float absmax = fmaxf(m, 1e-6f), r = 127.0f / absmax;
#pragma unroll
  for (int j = 0; j < SQ_MAX / SQ_THREADS / 4; ++j) {
    const int c = j * SQ_THREADS + t;
    if (c < n4) {
      uint32_t packed = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        packed |= (uint32_t)(uint8_t)(int8_t)__float2int_rn(__fmul_rn(h[4 * j + i], r)) << (8 * i);
      qr[c] = packed;
    }
  }
  if (t == 0) scale[row] = __fmul_rn(absmax, 1.0f / 127.0f);
}
extern "C" int bench_silu_quant(const float* gu, void* q, float* scale, int rows, int inter,
                                void* s) {
  if (inter % 4 != 0 || inter > SQ_MAX) return (int)cudaErrorInvalidValue;
  silu_quant_kernel<<<rows, SQ_THREADS, SQ_THREADS / 32 * sizeof(float),
                      static_cast<cudaStream_t>(s)>>>(
      gu, static_cast<int8_t*>(q), scale, inter);
  return (int)cudaGetLastError();
}
"""


def build(launches: dict, q_launches: dict) -> tuple:
    """A library of ``gemm_wide.cuh`` with one C entry per launch (label ->
    the text of a call over a, w, b, r, c, m, n, k, s), one per int8 launch
    (label -> a launch over a, w, e, c, m, n, k, s, with e the WgEpi of row
    scales rs, column scales cs, bias b and row maxima mx) and
    ``bench_silu_quant``; the entries, the int8 entries and the library."""
    out = ROOT / "build" / "bench_gemm_wide"
    out.mkdir(parents=True, exist_ok=True)
    unit = ['#include "gemm_wide.cuh"']
    for i, launch in enumerate(launches.values()):
        unit.append(
            f'extern "C" int bench_gemm_{i}(const void* a, const void* w, '
            'const float* b, const void* r, void* c, int m, int n, int k, '
            'void* s) {\n'
            f'  return (int){launch};\n}}')
    for i, launch in enumerate(q_launches.values()):
        unit.append(
            f'extern "C" int bench_q_{i}(const void* a, const void* w, '
            'const float* rs, const float* cs, const float* b, int* mx, '
            'void* c, int m, int n, int k, void* s) {\n'
            '  WgEpi e{};\n  e.row_scale = rs;\n  e.rs_stride = 1;\n'
            '  e.col_scale = cs;\n  e.bias = b;\n  e.row_max = mx;\n'
            f'  return (int){launch}(a, w, e, c, m, n, k, '
            'static_cast<cudaStream_t>(s));\n}')
    unit.append(SILU_QUANT)
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
    for i in range(len(q_launches)):
        fn = getattr(raw, f"bench_q_{i}")
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
    raw.bench_silu_quant.argtypes = ([ctypes.c_void_p] * 3
                                     + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    return ([getattr(raw, f"bench_gemm_{i}") for i in range(len(launches))],
            [getattr(raw, f"bench_q_{i}") for i in range(len(q_launches))],
            raw)


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


def run_qwen_shape(label, n, k, epi, fns, silu_quant, gen, iters):
    """Check and time the int8 variants of ``epi`` at one Qwen3 product
    beside ``torch._int_mm``; the SwiGLU forms at n = 2I also with their
    pass over h (the alternative's silu_quant_kernel)."""
    m = QWEN_ROWS
    a = torch.randint(-127, 128, (m, k), device="cuda", generator=gen,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), device="cuda", generator=gen,
                      dtype=torch.int8)
    rs = torch.rand(m, device="cuda", generator=gen) * 1e-3
    cs = torch.rand(n, device="cuda", generator=gen) * 1e-2
    zero = torch.zeros(n, device="cuda")
    ops = 2.0 * m * n * k
    t = time_ms(lambda: torch._int_mm(a, w.t()), iters)
    print(f"{label} [{m}, {k}] -> {n}: torch._int_mm {t:.4f} ms, "
          f"{ops / t / 1e9:.1f} TOP/s", flush=True)
    acc = torch._int_mm(a, w.t()).double()  # exact int32 sums
    f = acc.float() * rs[:, None] * cs  # (float(acc) * rs) * cs
    inter = n // 2
    stream = torch.cuda.current_stream().cuda_stream
    for cfg, (fn, form) in fns.items():
        if not (form == epi or (epi == "swiglu" and form == "swiglu_f32")):
            continue
        width = inter if form == "swiglu" else n
        dtype = torch.bfloat16 if form == "plain" else torch.float32
        c = torch.empty(m, width, device="cuda", dtype=dtype)
        mx = torch.zeros(m, device="cuda", dtype=torch.int32)
        call = lambda: fn(a.data_ptr(), w.data_ptr(), rs.data_ptr(),  # noqa: E731
                          cs.data_ptr(), zero.data_ptr(), mx.data_ptr(),
                          c.data_ptr(), m, width, k, stream)
        err = call()
        torch.cuda.synchronize()
        if form == "swiglu":
            g, u = f[:, :inter], f[:, inter:]
            ref = g * (1.0 / (1.0 + torch.exp(-g))) * u
            peak = (mx.view(torch.float32) - ref.abs().amax(1)).abs().max()
            note = f", row maxima max|d| {peak.item():.2e}"
        else:
            ref, note = f, ""
        rel = ((c.float() - ref).abs().max() / ref.abs().max()).item()
        t = time_ms(call, iters)
        print(f"    {cfg}: rc {err}, rel {rel:.2e}{note}, {t:.4f} ms, "
              f"{ops / t / 1e9:.1f} TOP/s", flush=True)
        if form == "swiglu_f32":
            q = torch.empty(m, inter, device="cuda", dtype=torch.int8)
            sc = torch.empty(m, device="cuda")
            err = silu_quant(c.data_ptr(), q.data_ptr(), sc.data_ptr(), m,
                             inter, stream)
            torch.cuda.synchronize()
            t = time_ms(lambda: silu_quant(c.data_ptr(), q.data_ptr(),
                                           sc.data_ptr(), m, inter, stream),
                        iters)
            print(f"    then silu_quant_kernel over g|u: rc {err}, {t:.4f} "
                  f"ms", flush=True)
            del q, sc
        del c, mx, ref
    del a, w, rs, cs, zero, acc, f
    torch.cuda.empty_cache()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--int8-only", action="store_true",
                        help="the int8 Qwen3 products alone")
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
    q_launches = {cfg: launch for cfg, (launch, _) in Q_VARIANTS.items()}
    wide_fns, q_fns, raw = build(wide, q_launches)
    fns = dict(zip(wide, wide_fns))
    gen = torch.Generator(device="cuda").manual_seed(0)
    qfns = {cfg: (fn, Q_VARIANTS[cfg][1]) for cfg, fn in zip(q_launches, q_fns)}
    for label, n, k, epi in QWEN_SHAPES:
        run_qwen_shape(label, n, k, epi, qfns, raw.bench_silu_quant, gen,
                       args.iters)
    if args.int8_only:
        return 0
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
