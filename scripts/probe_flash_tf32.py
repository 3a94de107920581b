"""Time and accuracy of the float32 flash kernels at head dims up to 256
(``csrc/flash_tf32.cu``: ``fwd_tf32``, ``bwd_rows_tf32``,
``bwd_keys_tf32``, every product in 3xTF32), as built and in variants
that each change one thing, compiled here (in parallel) from copies of
``unirec_tpu_torch/csrc`` (``flash_cross.cu``, ``flash_causal_bwd.cu`` and
``flash_tf32.cu``, with the tile products of ``flash_chunked.cuh``):

  as_built      the kernels (runs of RUN = 2 mma steps summed from zero);
  run4, run1    runs of 4 steps, of 1 step, before each fp32 add;
  four_products small . small issued too (a fourth mma a step);
  two_acc       the two cross products into an accumulator of their own,
                added to the big . big one after each step (shorter chains);
  rows_bk32     the backward over rows on 32-key tiles up to hd 128 (16
                from hd 80: one block an SM at hd 128, not two);
  one_product   big . big alone (plain TF32): one mma a step (time only);
  no_split      the operands handed to the mma as they are (time only);
  copy_rows_cols the copies of rows with copy_rows32's column test and
                pointer select (COLS), as the cluster kernels take them;
  unroll_full   scores32's loops unrolled by a bare ``#pragma unroll``, as
                before that sharing, not by their counts.

B14's forward and backward at the user stage's shape (64 users, 64 queries
over 1,600 memory rows, 16 heads of 64, ~15% masked keys, user 1 masked
whole) and B7b's dq and dk / dv at the joint training shape (B 8, L 512,
16 query / 8 key heads of 128, right-padded rows), through the port's
wrappers pointed at each variant's library.  Each is timed by CUDA events
over 20 calls after 3, and its outputs held to a float64 version of the
plain formula on the same inputs (``compare_flash_cross_builds.f64_cross``
and ``f64_causal``: the exact dot product, rounded to float32 as the
kernels round the score; max|d| / max|ref|; the backward from the float32
plain forward's m, l and dsum).  With ``--parent ROOT`` the other
checkout's kernels (its ``csrc``, the same C entries) are measured the same
way beside them; ``--variants`` builds only the variants named.  Prints
the card's name and power limit first, and each variant's registers and
spills.

    python3 scripts/probe_flash_tf32.py [--parent OTHER_ROOT]
        [--variants as_built,run4,...]
"""

from __future__ import annotations

import argparse
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
sys.path.insert(0, str(HERE / "scripts"))

import torch  # noqa: E402

from unirec_tpu_torch.ops import _build  # noqa: E402
from unirec_tpu_torch.ops import attention as pa  # noqa: E402
from unirec_tpu_torch.ops import flash_causal as fc  # noqa: E402
from unirec_tpu_torch.ops import flash_vjp as fl  # noqa: E402
from compare_flash_cross_builds import f64_causal, f64_cross  # noqa: E402

B, LQ, LKV, H, D = 64, 64, 1600, 16, 1024
CAUSAL = dict(B=8, L=512, HQ=16, HKV=8, HD=128)
HEADER, HELPERS, PRODUCTS = "flash_tf32.cu", "ptx_helpers.cuh", "flash_chunked.cuh"
SOURCES = ("flash_cross.cu", "flash_causal_bwd.cu", "flash_tf32.cu")
TIME_ONLY = ("one_product", "no_split")


def _replace(text: str, old: str, new: str) -> str:
    if old not in text:
        raise ValueError(f"not in the source: {old[:60]!r}")
    return text.replace(old, new, 1)


def _variants(header: str, helpers: str, products: str) -> dict:
    """name -> (tf32 header, ptx helpers, tile products) of each variant."""
    run = "constexpr int RUN = 2;"
    small = ("  for (int n = 0; n < N; ++n) mma_1688_tf32(t[n], as, bb[n][0], "
             "bb[n][1]);\n")
    big_small = ("  for (int n = 0; n < N; ++n) mma_1688_tf32(t[n], ab, bs[n][0], "
                 "bs[n][1]);\n")
    four = _replace(helpers, small, "  for (int n = 0; n < N; ++n) mma_1688_tf32("
                    "t[n], as, bs[n][0], bs[n][1]);\n" + small)
    one = _replace(_replace(helpers, small, ""), big_small, "")
    split = ("  big = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;\n"
             "  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;")
    no_split = _replace(helpers, split, "  big = __float_as_uint(x);\n  small = 0u;")
    three = ("  for (int n = 0; n < N; ++n) mma_1688_tf32(t[n], ab, bb[n][0], "
             "bb[n][1]);\n")
    two_acc = _replace(_replace(_replace(
        helpers, "#pragma unroll\n" + small,
        "  float u[N][4] = {};\n#pragma unroll\n" + small.replace("t[n]", "u[n]")),
        big_small, big_small.replace("t[n]", "u[n]")), three,
        three + "#pragma unroll\n  for (int n = 0; n < N; ++n)\n"
        "    for (int e = 0; e < 4; ++e) t[n][e] += u[n][e];\n")
    rows_bk32 = _replace(header, "  static constexpr int BK = HD <= 64 ? 32 : 16;",
                         "  static constexpr int BK = HD <= 128 ? 32 : 16;")
    copy_cols = header.replace("copy_rows32<LD, HD, S::THREADS>(",
                               "copy_rows32<LD, HD, S::THREADS, true>(")
    unroll_full = _replace(_replace(products, "#pragma unroll (OU)\n",
                                    "#pragma unroll\n"),
                           "#pragma unroll (IU)\n", "#pragma unroll\n")
    variants = {"as_built": (header, helpers),
                "two_acc": (header, two_acc), "rows_bk32": (rows_bk32, helpers),
                "run4": (_replace(header, run, "constexpr int RUN = 4;"), helpers),
                "run1": (_replace(header, run, "constexpr int RUN = 1;"), helpers),
                "four_products": (header, four), "one_product": (header, one),
                "no_split": (header, no_split)}
    return {**{n: (*v, products) for n, v in variants.items()},
            "copy_rows_cols": (copy_cols, helpers, products),
            "unroll_full": (header, helpers, unroll_full)}


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
    for kernel in ("fwd_tf32ILi64E", "bwd_rows_tf32ILi64ELb0ELb1",
                   "bwd_rows_tf32ILi128ELb1ELb0", "bwd_keys_tf32ILi128"):
        at = next((i for i, ln in enumerate(lines[:-2])
                   if "Function properties for" in ln and kernel in ln), None)
        if at is not None:
            regs.append(f"{kernel.split('IL')[0]}: "
                        f"{lines[at + 1].strip()}, {lines[at + 2].strip()}")
    return _build.Kernels(lib, out, 0.0, log), regs


def _time(fn, iters=20, warmup=3) -> float:
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


def _cross(gen):
    """B14's inputs, its runs and their float64 references."""
    q, do = (torch.randn(B, LQ, D, device="cuda", generator=gen)
             for _ in range(2))
    k3, v3 = (torch.randn(B, LKV, D, device="cuda", generator=gen)
              for _ in range(2))
    mask = (torch.rand(B, LKV, device="cuda", generator=gen) > 0.15).float()
    mask[1] = 0.0
    bias32 = ((1.0 - mask) * -1e9).contiguous()
    o, m, l = fl.flash_cross_fwd_plain(q, k3, v3, bias32, H)
    dsum = fl.attention_dsum(do, o, H).contiguous()
    o64, grads = f64_cross(q, k3, v3, bias32, do, m, l, dsum, H)
    return {"B14 fwd": (lambda: fl.flash_cross_fwd(q, k3, v3, bias32, H)[:1],
                        [o64]),
            "B14 bwd": (lambda: fl.flash_cross_bwd(q, k3, v3, bias32, do, m, l,
                                                   dsum, H), grads)}


def _causal(gen):
    """B7b's inputs, its runs and their float64 references."""
    b, seq, hq, hkv, hd = (CAUSAL[x] for x in ("B", "L", "HQ", "HKV", "HD"))
    lengths = torch.randint(1, seq + 1, (b,), device="cuda", generator=gen)
    lengths[-1] = seq
    mask = (torch.arange(seq, device="cuda")[None] < lengths[:, None]).float()
    q, k, v, do = (torch.randn(b, seq, h * hd, device="cuda", generator=gen)
                   for h in (hq, hkv, hkv, hq))
    o, m, l = fc.flash_causal_attention_fwd_plain(q, k, v, mask, hq, hkv)
    dsum = fc.attention_dsum(do, o, hq).contiguous()
    args = (q, k, v, mask, do, m, l, dsum, hq, hkv)
    dq, dk, dv = f64_causal(*args)
    return {"B7b dq": (lambda: (fc.flash_causal_bwd_dq(*args),), [dq]),
            "B7b dk/dv": (lambda: fc.flash_causal_bwd_dkv(*args), [dk, dv])}


def _errors(run, refs) -> list:
    got = run()
    return [((g.double() - r).abs().max() / r.abs().max()).item()
            for g, r in zip(got, refs)]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", help="another checkout to measure beside")
    parser.add_argument("--variants", help="the variants to build, "
                        "comma-separated (all by default)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("probe_flash_tf32: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    csrc = HERE / "unirec_tpu_torch" / "csrc"
    variants = _variants(*((csrc / f).read_text()
                           for f in (HEADER, HELPERS, PRODUCTS)))
    if args.variants:
        variants = {n: variants[n] for n in args.variants.split(",")}
    tmp = Path(tempfile.mkdtemp(prefix="probe_flash_tf32_"))
    try:
        dirs = {}
        for name, texts in variants.items():
            shutil.copytree(csrc, tmp / name / "csrc")
            for fname, text in zip((HEADER, HELPERS, PRODUCTS), texts):
                (tmp / name / "csrc" / fname).write_text(text)
            dirs[name] = tmp / name / "csrc"
        if args.parent:
            dirs["parent"] = Path(args.parent).resolve() / "unirec_tpu_torch" / "csrc"
        with ThreadPoolExecutor(len(dirs)) as pool:
            built = dict(zip(dirs, pool.map(
                lambda n: _lib(dirs[n], tmp / f"{n}_lib"), dirs)))
        gen = torch.Generator(device="cuda").manual_seed(0)
        runs = {**_cross(gen), **_causal(gen)}
        form = pa._chunked_form
        for name, (kernels, regs) in built.items():
            for mod in (pa, fl, fc):
                mod.load_kernels = lambda k=kernels: k
            form.cache_clear()
            # a parent's C entries may not know this checkout's kinds: at
            # these head dims they count no form
            pa._chunked_form = (lambda *a: None) if name == "parent" else form
            parts = []
            for r, (fn, refs) in runs.items():
                part = f"{r} {_time(fn):.4f} ms"
                if name not in TIME_ONLY:
                    part += " (rel " + " / ".join(
                        f"{e:.2e}" for e in _errors(fn, refs)) + ")"
                parts.append(part)
            print(f"{name}: " + ", ".join(parts)
                  + f" [{'; '.join(regs) or 'no ptxas line'}]", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
