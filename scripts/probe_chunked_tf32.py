"""Where the time of the float32 chunked flash kernels goes
(``csrc/flash_chunked_cluster.cuh``: ``chunk_fwd_cl32``,
``chunk_bwd_rows_cl32``, every product in 3xTF32): B13, B14's forward and
B14's backward at 8 users (and the backward at 64) in 2 heads of 512 over
1,600 memory rows with ~15% masked keys, and K1 and B7b's dq at hd 512 (B 2,
L 512, 4 query / 2 key heads, rows of 512 and 301 keys), through the port's
wrappers pointed at the kernels as built and at variants with one part
taken out, each compiled here (in parallel) from a copy of
``unirec_tpu_torch/csrc`` (``flash_cross.cu``, ``flash_causal_fwd.cu`` and
``flash_causal_bwd.cu``):

  as_built     the kernels;
  one_product  each product as big . big alone (plain TF32): one mma a step
               where 3xTF32 issues three;
  cvt_rna      the split's roundings by cvt.rna.tf32.f32 instead of integer
               adds and masks on the bit pattern (the same bits reach the
               mma);
  no_split     the operands handed to the mma as they are (big = x, small
               = 0): three mma a step without the split's conversions;
  no_exchange  neither the reads of the other blocks' partial scores (each
               block sums its own C times) nor the cluster barrier of each
               key tile;
  no_scores    without the partial products S_c = Q_c K_c^T and dP_c =
               dO_c V_c^T;
  no_dkv       the backward without B14's dk / dv products.

Each is timed by CUDA events over 30 calls after 3.  Outputs of the
variants are not checked: they compute something else.  Prints the card's
name and power limit first, and each variant's registers and spills.

    python3 scripts/probe_chunked_tf32.py
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
import tempfile
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

import torch  # noqa: E402

from unirec_tpu_torch.ops import _build  # noqa: E402
from unirec_tpu_torch.ops import attention as pa  # noqa: E402
from unirec_tpu_torch.ops import flash_causal as fc  # noqa: E402
from unirec_tpu_torch.ops import flash_vjp as fl  # noqa: E402

LQ, LKV, H, HD = 64, 1600, 2, 512
CAUSAL = dict(B=2, L=512, HQ=4, HKV=2, HD=512, LENGTHS=(512, 301))
HEADER, HELPERS = "flash_chunked_cluster.cuh", "ptx_helpers.cuh"
SOURCES = ("flash_cross.cu", "flash_causal_fwd.cu", "flash_causal_bwd.cu")


def _replace(text: str, old: str, new: str, start: int = 0) -> str:
    at = text.index(old, start)
    return text[:at] + new + text[at + len(old):]


def _variants(header: str, helpers: str) -> dict:
    """name -> (cluster header, ptx helpers) of each variant."""
    fp32 = header.index("chunk_fwd_cl32(")
    one = _replace(helpers, "  for (int n = 0; n < N; ++n) mma_1688_tf32(t[n], as, bb[n][0], "
                   "bb[n][1]);\n", "")
    one = _replace(one, "  for (int n = 0; n < N; ++n) mma_1688_tf32(t[n], ab, bs[n][0], "
                   "bs[n][1]);\n", "")
    cvt_rna = _replace(helpers, "  big = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;\n"
                       "  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;",
                       "  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(big) : \"f\"(x));\n"
                       "  big &= 0xFFFFE000u;\n  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : "
                       "\"=r\"(small) : \"f\"(x - __uint_as_float(big)));")
    no_split = _replace(helpers, "  big = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;\n"
                        "  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;",
                        "  big = __float_as_uint(x);\n  small = 0u;")
    no_exchange = _replace(
        header, "x[n] = ld_cluster_f32x4(cluster_map(at + n * (BQ / 16) * 32 * 16, r));",
        "x[n] = *reinterpret_cast<const float4*>(X + ((n * (BQ / 16) + rg) * 32 + lane) * 4);")
    for old in ("      cluster_arrive();\n      continue;\n",
                "    cluster_wait();  // every rank's partial of this tile is in "
                "its exchange\n",
                "    cluster_arrive();\n    cluster_wait();  // every rank's "
                "partials of this tile are in its exchange\n"):
        keep = "      continue;\n" if old.endswith("continue;\n") else ""
        no_exchange = _replace(no_exchange, old, keep,
                               no_exchange.index("chunk_fwd_cl32("))
    no_scores = header
    for call in ("        scores32<LDF, CW, NTH, RUN32, 1, 2>(own, Qs, tile + hk * NTH * 8 * LDF, r0, "
                 "lane);\n",
                 "        scores32<LDF, CW, 1, RUN32, 1, 2>(own_dp, dOs, tile + hk * 8 * LDF, r0, lane);\n",
                 "      scores32<LDF, CW, 1, RUN32, 1, 2>(own_s, Qs, tile + hk * 8 * LDF, r0, lane);\n"):
        no_scores = _replace(no_scores, call, "", fp32)
    no_dkv = _replace(header, "    if constexpr (DKV) {\n      __syncthreads();  // p and ds of "
                      "every row written\n      // warp w:", "    if constexpr (false) {\n"
                      "      __syncthreads();  // p and ds of every row written\n      // warp w:",
                      fp32)
    return {"as_built": (header, helpers), "cvt_rna": (header, cvt_rna),
            "one_product": (header, one),
            "no_split": (header, no_split), "no_exchange": (no_exchange, helpers),
            "no_scores": (no_scores, helpers), "no_dkv": (no_dkv, helpers)}


class _Entries:
    """The library as ``_build.bind`` sees it: entries of sources not built
    here get a placeholder."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        try:
            return getattr(self._lib, name)
        except AttributeError:
            setattr(self, name, types.SimpleNamespace())
            return getattr(self, name)


def _lib(csrc: Path, work: Path):
    out = work / "lib.so"
    log = _build._compile([csrc / s for s in SOURCES], out)
    lib = _build.bind(_Entries(ctypes.CDLL(str(out))))
    lines = log.splitlines()
    regs = []
    for kernel in ("chunk_fwd_cl32", "chunk_bwd_rows_cl32"):  # a first instance
        at = next((i for i, ln in enumerate(lines[:-2])
                   if "Function properties for" in ln and kernel in ln), None)
        if at is not None:
            regs.append(f"{kernel}: {lines[at + 1].strip()}, "
                        f"{lines[at + 2].strip()}")
    return _build.Kernels(lib, out, 0.0, log), regs


def _time(fn, iters=30, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _cross(gen, b):
    d = H * HD
    q, do = (torch.randn(b, LQ, d, device="cuda", generator=gen)
             for _ in range(2))
    k3, v3 = (torch.randn(b, LKV, d, device="cuda", generator=gen)
              for _ in range(2))
    mask = (torch.rand(b, LKV, device="cuda", generator=gen) > 0.15).float()
    mask[1] = 0.0
    bias = ((1.0 - mask) * -1e9)[:, None, None, :]
    return q, k3, v3, do, bias, pa.key_bias(bias, b, LKV, q.device)


def _runs(gen) -> dict:
    runs = {}
    for b in (8, 64):
        q, k3, v3, do, bias, bias32 = _cross(gen, b)
        o, m, l = fl.flash_cross_fwd_plain(q, k3, v3, bias32, H)
        dsum = fl.attention_dsum(do, o, H).contiguous()
        if b == 8:
            qh, kh, vh = (pa.split_heads(t, H) for t in (q, k3, v3))
            runs["B13 8u"] = (lambda a=(qh, kh, vh, bias):
                              pa.flash_cross_attention(*a))
            runs["B14 fwd 8u"] = (lambda a=(q, k3, v3, bias32):
                                  fl.flash_cross_fwd(*a, H))
        runs[f"B14 bwd {b}u"] = (lambda a=(q, k3, v3, bias32, do, m, l, dsum):
                                 fl.flash_cross_bwd(*a, H))
    b, l, hq, hkv, hd = (CAUSAL[x] for x in ("B", "L", "HQ", "HKV", "HD"))
    qc, kc, vc, doc = (torch.randn(b, l, n * hd, device="cuda", generator=gen)
                       for n in (hq, hkv, hkv, hq))
    mask = (torch.arange(l, device="cuda")[None]
            < torch.tensor(CAUSAL["LENGTHS"], device="cuda")[:, None]).float()
    oc, mc, lc = fc.flash_causal_attention_fwd_plain(qc, kc, vc, mask, hq, hkv)
    dsc = fc.attention_dsum(doc, oc, hq).contiguous()
    runs["K1 hd512"] = lambda: fc.flash_causal_attention(qc, kc, vc, mask, hq,
                                                         hkv)
    runs["dq hd512"] = lambda: fc.flash_causal_bwd_dq(qc, kc, vc, mask, doc,
                                                      mc, lc, dsc, hq, hkv)
    return runs


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_chunked_tf32: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    csrc = HERE / "unirec_tpu_torch" / "csrc"
    variants = _variants((csrc / HEADER).read_text(),
                         (csrc / HELPERS).read_text())
    tmp = Path(tempfile.mkdtemp(prefix="probe_tf32_"))
    try:
        for name, (header, helpers) in variants.items():
            shutil.copytree(csrc, tmp / name / "csrc")
            (tmp / name / "csrc" / HEADER).write_text(header)
            (tmp / name / "csrc" / HELPERS).write_text(helpers)
        with ThreadPoolExecutor(len(variants)) as pool:
            built = list(pool.map(lambda n: _lib(tmp / n / "csrc", tmp / n),
                                  variants))
        runs = _runs(torch.Generator(device="cuda").manual_seed(0))
        for name, (kernels, regs) in zip(variants, built):
            for mod in (pa, fl, fc):
                mod.load_kernels = lambda k=kernels: k
            pa._chunked_form.cache_clear()
            times = {r: _time(fn) for r, fn in runs.items()}
            print(f"{name}: " + ", ".join(f"{r} {t:.4f} ms"
                                          for r, t in times.items())
                  + f" ({'; '.join(regs) or 'no ptxas line'})", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
