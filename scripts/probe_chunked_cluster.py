"""Where the time of the cluster form of the chunked bf16 flash kernels goes
(``csrc/flash_chunked_cluster.cuh``: ``chunk_fwd_cl``, ``chunk_bwd_rows_cl``):
B13 at one head of 1536 (6 chunks) and B14's backward at one head of 1024
(4 chunks), 64 queries over 1,600 memory rows with ~15% masked keys, and
B7b's dq at hd 768 (B 2, L 512, 4 query / 2 key heads, rows of 512 and 301
keys), through the port's wrappers pointed at the kernels as built and at
variants with one part taken out, each compiled here (in parallel) from a
copy of ``unirec_tpu_torch/csrc`` (``flash_cross.cu`` and
``flash_causal_bwd.cu``):

  as_built     the kernels;
  no_remote    the partials of the other blocks not read (each block sums
               its own C times): the cluster barrier stays;
  no_exchange  neither the reads nor the cluster barrier of each key tile;
  no_scores    without the partial products S_c = Q_c K_c^T and dP_c =
               dO_c V_c^T;
  no_dkv       the backward without B14's dk / dv products.

B13 runs with the key splits of ``ops/attention.chunked_plan`` and with
one split; B14's backward at 8 and 64 users.  Each is timed by CUDA events
over 50 calls after 5.  Outputs of the variants are not checked: they
compute something else.  Prints the card's name and power limit first.

    python3 scripts/probe_chunked_cluster.py
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

LQ, LKV = 64, 1600
CAUSAL = dict(B=2, L=512, HQ=4, HKV=2, HD=768, LENGTHS=(512, 301))
HEADER = "flash_chunked_cluster.cuh"
SOURCES = ("flash_cross.cu", "flash_causal_bwd.cu")


def _variants(text: str) -> dict:
    remote = ": ld_cluster_f32x4(cluster_map(at + n * TTHREADS * 16, r));"
    no_remote = text.replace(
        remote, ": make_float4(own[n][0], own[n][1], own[n][2], own[n][3]);")
    barriers = (
        ("      cluster_arrive();\n      continue;\n", "      continue;\n"),
        ("    cluster_wait();  // every rank's partial of this tile is in its "
         "exchange\n", ""),
        ("    cluster_arrive();\n    cluster_wait();  // every rank's partials "
         "of this tile are in its exchange\n", ""))
    no_exchange = no_remote
    for old, new in barriers:
        no_exchange = no_exchange.replace(old, new, 1)
    no_scores = text
    for call in ("        chunk_scores(own, Qs, tile, r0, lane);\n",
                 "        chunk_scores(own_dp, dOs, tile, r0, lane);\n",
                 "      chunk_scores(own_s, Qs, tile, r0, lane);\n"):
        no_scores = no_scores.replace(call, "", 1)
    k = text.index("chunk_bwd_rows_cl(")
    a = text.index("      // unit w: dv (w < UNITS / 2)", k)
    b = text.index("  cp_async_wait<0>();\n", a)
    no_dkv = text[:a] + "    }\n  }\n" + text[b:]
    out = {"as_built": text, "no_remote": no_remote,
           "no_exchange": no_exchange, "no_scores": no_scores,
           "no_dkv": no_dkv}
    for name, t in out.items():
        if name != "as_built" and t == text:
            raise RuntimeError(f"variant {name} changed nothing")
    if no_exchange.count("cluster_arrive();") != 2:  # the two last barriers
        raise RuntimeError("no_exchange kept a barrier of the key loop")
    return out


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
    for kernel in ("chunk_fwd_cl", "chunk_bwd_rows_cl"):  # a first instance
        at = next((i for i, ln in enumerate(lines[:-2])
                   if "Function properties for" in ln and kernel in ln), None)
        if at is not None:
            regs.append(f"{kernel}: {lines[at + 1].strip()}, "
                        f"{lines[at + 2].strip()}")
    return _build.Kernels(lib, out, 0.0, log), regs


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


def _cross(gen, b, hd):
    q, do = (torch.randn(b, LQ, hd, device="cuda", generator=gen).bfloat16()
             for _ in range(2))
    k3, v3 = (torch.randn(b, LKV, hd, device="cuda", generator=gen)
              .bfloat16() for _ in range(2))
    mask = (torch.rand(b, LKV, device="cuda", generator=gen) > 0.15).float()
    mask[1] = 0.0
    bias = ((1.0 - mask) * -1e9)[:, None, None, :]
    return q, k3, v3, do, bias, pa.key_bias(bias, b, LKV, q.device)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_chunked_cluster: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    csrc = HERE / "unirec_tpu_torch" / "csrc"
    variants = _variants((csrc / HEADER).read_text())
    tmp = Path(tempfile.mkdtemp(prefix="probe_cluster_"))
    try:
        for name, t in variants.items():
            shutil.copytree(csrc, tmp / name / "csrc")
            (tmp / name / "csrc" / HEADER).write_text(t)
        with ThreadPoolExecutor(len(variants)) as pool:
            built = list(pool.map(lambda n: _lib(tmp / n / "csrc", tmp / n),
                                  variants))
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k3, v3, _, bias, _ = _cross(gen, 8, 1536)
        qh, kh, vh = (pa.split_heads(t, 1) for t in (q, k3, v3))
        runs = {"B13 1x1536 8 users": lambda: pa.flash_cross_attention(
            qh, kh, vh, bias)}
        split_plan = pa.chunked_fwd_splits

        def one_split():
            pa.chunked_fwd_splits = lambda *a: 1
            try:
                pa.flash_cross_attention(qh, kh, vh, bias)
            finally:
                pa.chunked_fwd_splits = split_plan
        runs["B13 1x1536 8 users, one split"] = one_split
        for b in (8, 64):
            q, k3, v3, do, _, bias32 = _cross(gen, b, 1024)
            o, m, l = fl.flash_cross_fwd_plain(q, k3, v3, bias32, 1)
            dsum = fl.attention_dsum(do, o, 1).contiguous()
            runs[f"B14 bwd 1x1024 {b} users"] = (
                lambda a=(q, k3, v3, bias32, do, m, l, dsum):
                fl.flash_cross_bwd(*a, 1))
        b, l, hq, hkv, hd = (CAUSAL[x] for x in ("B", "L", "HQ", "HKV", "HD"))
        qc, kc, vc, doc = (torch.randn(b, l, n * hd, device="cuda",
                                       generator=gen).bfloat16()
                           for n in (hq, hkv, hkv, hq))
        mask = (torch.arange(l, device="cuda")[None]
                < torch.tensor(CAUSAL["LENGTHS"], device="cuda")[:, None]
                ).float()
        oc, mc, lc = fc.flash_causal_attention_fwd_plain(qc, kc, vc, mask, hq,
                                                         hkv)
        dsc = fc.attention_dsum(doc, oc, hq).contiguous()
        runs["B7b dq hd 768"] = lambda: fc.flash_causal_bwd_dq(
            qc, kc, vc, mask, doc, mc, lc, dsc, hq, hkv)
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
