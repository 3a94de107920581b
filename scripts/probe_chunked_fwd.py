"""Where the chunked bf16 forward's time goes (``csrc/flash_chunked.cuh``,
``chunk_fwd_tc``): B13 at head dim 512 (2 heads, 64 queries over 1,600
memory rows; 8 and 64 users) through its C entry, the kernel as built and
variants with one part taken out of its key loop, each compiled here (in
parallel) from a copy of ``unirec_tpu_torch/csrc`` with ``flash_cross.cu``
alone:

  as_built   the kernel (and its merge launch where the keys are split);
  no_scores  without the score products (``chunk_scores``);
  no_pv      without the P . V products;
  no_loads   without the ring's loads after the prologue (the units hold
             whatever the prologue left: timing only);
  loads_only the ring's loads and barriers alone;
  no_softmax without the online softmax (P is the scores as they are);
  no_barrier without the barrier of each unit (races: timing only).

Then K1 at B 2, L 512, 4 query / 2 key heads of 512 (rows of 512 and 301
keys) through its C entry, beside ``scaled_dot_product_attention`` on the
same inputs.

Each is timed by CUDA events over 50 launches after 5 (no wrapper: the C
entry called directly) with the key splits the wrapper plans
(``ops/attention.chunked_plan``; the kernel as built also unsplit),
beside the wrapper ``flash_cross_attention`` of the built library (its host
work included).  Outputs of the variants are not
checked: they compute something else.

    python3 scripts/probe_chunked_fwd.py
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

import torch  # noqa: E402

from unirec_tpu_torch.ops import _build  # noqa: E402
from unirec_tpu_torch.ops import attention as pa  # noqa: E402

LQ, LKV, H, HD = 64, 1600, 2, 512
SCORES = "      chunk_scores(s, Qs + i * QCH, tile, r0, lane);\n"
PREFETCH = "    if (u + S - 1 < n_units) load_unit(u + S - 1);\n"


def _variants(text: str) -> dict:
    out = {"as_built": text,
           "no_scores": text.replace(SCORES, ""),
           "no_loads": text.replace(PREFETCH, "", 1)}
    start = text.index("    // O += P V_c: P (bf16; hi and lo with F32O) from the S")
    end = text.index("  cp_async_wait<0>();\n\n#pragma unroll\n  for (int r = 0; r < 2; ++r) {\n"
                     "    l_run[r] += __shfl_xor_sync")
    out["no_pv"] = text[:start] + "  }\n" + text[end:]
    body_start = text.index("    const int i = u % U;\n    const int k0 = (t0 + u / U) * TK;\n"
                            "    const bf16* tile = ring + (u % S) * UNIT;\n    // causal: a warp")
    out["loads_only"] = text[:body_start] + "  }\n" + text[end:]
    soft = text.index("    const float* kt = kin + (u / U % S) * TK;\n    float mx[2]")
    soft_end = text.index("    if constexpr (!F32O) {\n#pragma unroll\n      for (int n = 0; "
                          "n < CW / 8; ++n) {")
    out["no_softmax"] = (text[:soft] + "    float alpha[2] = {1.f, 1.f};\n"
                         + text[soft_end:])
    out["no_barrier"] = text.replace(
        "    __syncthreads();            // ... for every thread, and unit u - 1's "
        "stage is free\n", "", 1)
    for name, t in out.items():
        if name != "as_built" and t == text:
            raise RuntimeError(f"variant {name} changed nothing")
    return out


def _lib(csrc: Path, work: Path, causal: bool = False) -> ctypes.CDLL:
    out = work / "lib.so"
    srcs = [csrc / "flash_cross.cu"] + ([csrc / "flash_causal_fwd.cu"]
                                         if causal else [])
    log = _build._compile(srcs, out)
    lib = ctypes.CDLL(str(out))
    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.unirec_flash_cross_fwd.argtypes = [P] * 8 + [L] * 12 + [I] * 7 + [
        ctypes.c_float, P]
    lib.unirec_flash_cross_fwd.restype = I
    if causal:
        lib.unirec_flash_causal_fwd.argtypes = [P] * 8 + [I] * 7 + [
            ctypes.c_float, P]
        lib.unirec_flash_causal_fwd.restype = I
    lines = log.splitlines()
    spill = [lines[i + 1].strip() for i, ln in enumerate(lines[:-1])
             if "Function properties for" in ln
             and "chunk_fwd_tcI13__nv_bfloat16Lb0" in ln]
    return lib, spill


def _time(fn, iters=50, warmup=5) -> float:
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


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_chunked_fwd: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    src = HERE / "unirec_tpu_torch" / "csrc"
    text = (src / "flash_chunked.cuh").read_text()
    tmp = Path(tempfile.mkdtemp(prefix="probe_chunked_"))
    try:
        variants = _variants(text)
        for name, variant in variants.items():
            shutil.copytree(src, tmp / name / "csrc")
            (tmp / name / "csrc" / "flash_chunked.cuh").write_text(variant)
        with ThreadPoolExecutor(len(variants)) as pool:  # nvcc in parallel
            built = pool.map(lambda n: _lib(tmp / n / "csrc", tmp / n,
                                            n == "as_built"), variants)
        libs = dict(zip(variants, built))
        gen = torch.Generator(device="cuda").manual_seed(0)
        for b in (8, 64):
            q = torch.randn(b, LQ, H * HD, device="cuda", generator=gen).bfloat16()
            k, v = (torch.randn(b, LKV, H * HD, device="cuda", generator=gen)
                    .bfloat16() for _ in range(2))
            bias = torch.zeros(b, LKV, device="cuda")
            o = torch.empty_like(q)
            qh, kh, vh, oh = (pa.split_heads(t, H) for t in (q, k, v, o))
            strides = [s for t in (qh, kh, vh, oh) for s in t.stride()[:3]]
            stream = torch.cuda.current_stream().cuda_stream
            splits, part = pa.chunked_plan(q, pa.CHUNKED_FWD, b, H, LQ, LKV,
                                           HD, "tensor_cores")
            for name, (lib, spill) in libs.items():
                for n, scratch in {(splits, part), (1, None)}:
                    if n == 1 and name != "as_built" and splits > 1:
                        continue

                    def run(lib=lib, n=n, scratch=scratch):
                        err = lib.unirec_flash_cross_fwd(
                            q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            bias.data_ptr(), o.data_ptr(), None, None,
                            None if scratch is None else scratch.data_ptr(),
                            *strides, b, H, LQ, LKV, HD, 1, n, pa.sm_scale(HD),
                            stream)
                        assert err == 0, err
                    print(f"{b} users {name}, {n} key split(s): "
                          f"{_time(run):.4f} ms "
                          f"({'; '.join(spill) or 'no ptxas spill line'})",
                          flush=True)
            wrapped = _time(lambda: pa.flash_cross_attention(
                qh, kh, vh, bias[:, None, None, :]))
            print(f"{b} users flash_cross_attention (wrapper, built "
                  f"library): {wrapped:.4f} ms", flush=True)
        _k1(libs["as_built"][0], gen)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


def _k1(lib, gen) -> None:
    b, l, hq, hkv = 2, 512, 4, 2
    q = torch.randn(b, l, hq * HD, device="cuda", generator=gen).bfloat16()
    k, v = (torch.randn(b, l, hkv * HD, device="cuda", generator=gen)
            .bfloat16() for _ in range(2))
    mask = (torch.arange(l, device="cuda")[None]
            < torch.tensor([512, 301], device="cuda")[:, None]).float()
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = lib.unirec_flash_causal_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            o.data_ptr(), None, None, None, b, l, hq, hkv, HD, 1, 1,
            pa.sm_scale(HD), stream)
        assert err == 0, err
    print(f"K1 B {b} L {l} {hq}/{hkv} heads of {HD}: {_time(run):.4f} ms",
          flush=True)
    qh = q.reshape(b, l, hq, HD).transpose(1, 2)
    kh, vh = (t.reshape(b, l, hkv, HD).transpose(1, 2)
              .repeat_interleave(hq // hkv, 1) for t in (k, v))
    allowed = (torch.ones(l, l, device="cuda").tril().bool()[None, None]
               & mask.bool()[:, None, None, :])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    print(f"K1's shape, scaled_dot_product_attention: "
          f"{_time(lambda: sdpa(qh, kh, vh, attn_mask=allowed)):.4f} ms",
          flush=True)


if __name__ == "__main__":
    sys.exit(main())
