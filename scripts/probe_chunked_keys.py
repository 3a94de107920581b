"""Where the time of B7b's chunked dk / dv on tensor cores goes
(``csrc/flash_chunked.cuh``, ``chunk_bwd_keys_tc``): at chip_smoke.py's
WIDE_CAUSAL shape (B 2, L 512, 4 query / 2 key heads of 512, rows of 512
and 301 keys, bf16) through its C entry, the kernel as built and variants
with one part taken out of its loop, each compiled here (in parallel) from
a copy of ``unirec_tpu_torch/csrc`` with ``flash_causal_bwd.cu`` alone:

  as_built    the kernel;
  no_scores   without the S^T and dP^T products (``chunk_scores``);
  no_product  without the dv += p^T dO and dk += ds^T Q products;
  no_pds      without p^T and ds^T (the products read what is there);
  loads_only  the ring's loads and barriers alone;
  no_barrier  without the ring's barrier of each stage (races: timing only);
  two_stages  a ring of 2 stages.

Each is timed by CUDA events over 50 launches after 5 (the C entry called
directly, no wrapper).  m, l and dsum come from the plain forward on the
card.  Outputs of the variants are not checked: they compute something
else.  Prints the card's name and power limit first.

    python3 scripts/probe_chunked_keys.py
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
from unirec_tpu_torch.ops import flash_causal as fc  # noqa: E402

B, L, HQ, HKV, HD, LENGTHS = 2, 512, 4, 2, 512, (512, 301)
KERNEL = "chunk_bwd_keys_tc("


def _cut(text: str, start: str, end: str, put: str = "") -> str:
    """text with [start, end) of the dk / dv kernel replaced by put."""
    k = text.index(KERNEL)
    a = text.index(start, k)
    b = text.index(end, a)
    return text[:a] + put + text[b:]


def _variants(text: str) -> dict:
    k = text.index(KERNEL)
    head, body = text[:k], text[k:]
    out = {"as_built": text}
    scores = ("      if (live)  // S^T_cc = K_cc Q_cc^T, dP^T_cc = V_cc dO_cc^T\n"
              "        chunk_scores(part[x], (dp_warp ? Vs : Ks) + x * UNIT,\n"
              "                     slot + (dp_warp ? UNIT : 0) + rw * LDC, kw, lane);\n")
    out["no_scores"] = head + body.replace(scores, "", 1)
    out["no_product"] = _cut(text, "    const bf16* as = dp_warp ? dSt : Pt;",
                             "  cp_async_wait<0>();\n", "  }\n")
    out["no_pds"] = _cut(text, "    if (!dp_warp) {  // p^T and ds^T",
                         "    __syncthreads();  // p^T and ds^T written")
    out["loads_only"] = _cut(text, "    const int j = u % C, cc = (c + 1 + j) % C;",
                             "  cp_async_wait<0>();\n", "  }\n")
    out["no_barrier"] = head + body.replace(
        "    __syncthreads();            // ... for every thread; unit u - 1's "
        "stage is free\n", "", 1)
    out["two_stages"] = text.replace(
        "  return C > KEYS_MAX_C || fit < 2 ? 0 : (fit < MAX_STAGES ? fit : MAX_STAGES);",
        "  return C > KEYS_MAX_C || fit < 2 ? 0 : 2;", 1)
    for name, t in out.items():
        if name != "as_built" and t == text:
            raise RuntimeError(f"variant {name} changed nothing")
    return out


def _lib(csrc: Path, work: Path):
    out = work / "lib.so"
    log = _build._compile([csrc / "flash_causal_bwd.cu"], out)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.unirec_flash_causal_bwd_dkv.argtypes = [P] * 10 + [I] * 6 + [
        ctypes.c_float, P]
    lib.unirec_flash_causal_bwd_dkv.restype = I
    lines = log.splitlines()
    regs = [lines[i + 2].strip() for i, ln in enumerate(lines[:-2])
            if "Function properties for" in ln and "chunk_bwd_keys_tc" in ln]
    return lib, regs[:1]


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
        print("probe_chunked_keys: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    csrc = HERE / "unirec_tpu_torch" / "csrc"
    text = (csrc / "flash_chunked.cuh").read_text()
    variants = _variants(text)
    tmp = Path(tempfile.mkdtemp(prefix="probe_keys_"))
    try:
        for name, t in variants.items():
            shutil.copytree(csrc, tmp / name / "csrc")
            (tmp / name / "csrc" / "flash_chunked.cuh").write_text(t)
        with ThreadPoolExecutor(len(variants)) as pool:
            built = list(pool.map(lambda n: _lib(tmp / n / "csrc", tmp / n),
                                  variants))
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, do = (torch.randn(B, L, n * HD, device="cuda", generator=gen)
                       .bfloat16() for n in (HQ, HKV, HKV, HQ))
        mask = (torch.arange(L, device="cuda")[None]
                < torch.tensor(LENGTHS, device="cuda")[:, None]).float()
        o, m, l = fc.flash_causal_attention_fwd_plain(q, k, v, mask, HQ, HKV)
        dsum = fc.attention_dsum(do, o, HQ).contiguous()
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        stream = torch.cuda.current_stream().cuda_stream
        for name, (lib, regs) in zip(variants, built):
            def run(lib=lib):
                err = lib.unirec_flash_causal_bwd_dkv(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                    do.data_ptr(), m.data_ptr(), l.data_ptr(), dsum.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), B, L, HQ, HKV, HD, 1,
                    pa.sm_scale(HD), stream)
                assert err == 0, err
            print(f"dk / dv {name}: {_time(run):.4f} ms "
                  f"({'; '.join(regs) or 'no ptxas line'})", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
