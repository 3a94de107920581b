"""Where K2's and B11's time goes on the card, without a profiler that sees
inside a kernel: the share pass of ``csrc/retrieve_topk.cu`` is rebuilt with
parts taken out, and each form is timed as ``chip_smoke.py`` times the
kernels (``chip_smoke.retrieval_device_ms``: device ms a launch from
``torch.profiler``, L2 flushed before each call by writing and reading a
128 MB buffer), at 8 and 64 users over a 20,000 x 1,024 catalog, k 20.

    python3 scripts/profile_retrieval_parts.py

Forms: ``full``; ``noselect`` (no tile selection: the share lists stay
empty); ``nodots`` (no dot products: the consumers wait for each stage, sum
its squares and select over stale values); ``stream`` (neither dot products
nor sums of squares: the producer's stream, the stage handshakes and the
selection).  Only ``full`` computes the function; the others split its
time.  Each form is one ``nvcc`` of the source alone (all started
together), under ``build/retrieval_parts/``.  Prints one line per kernel
and user count: the share pass's ms and the merge's, for each form.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts" / "emulate_cuda"))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from check_attention import _Entries  # noqa: E402
from unirec_tpu_torch.ops import _build  # noqa: E402
from unirec_tpu_torch.ops.quantization import quantize_rows  # noqa: E402
from unirec_tpu_torch.ops.ranking import retrieval_plan, sm_count  # noqa: E402

N, D, K, ITERS = 20_000, 1_024, 20, 20  # chip_smoke.py's catalog and k
CSRC = ROOT / "unirec_tpu_torch" / "csrc"
SELECT = "      select_tile<P>(ls, li, dots_u, su, rscale, t0, v, k, lane);\n"
DOTS_FROM = "    switch (R) {\n      case 1: dots<"
SQUARES = ("    if (fold) {  // sums of squares", "    const int tg = g;")


def forms(src: str) -> dict:
    """The source with parts taken out, by its own text."""
    def cut_dots(text: str) -> str:
        i = text.index(DOTS_FROM)
        return text[:i] + text[text.index("    }\n", i) + 6:]

    out = {"full": src, "noselect": src.replace(SELECT, ""),
           "nodots": cut_dots(src)}
    stream = out["nodots"]
    out["stream"] = (stream[:stream.index(SQUARES[0])]
                     + stream[stream.index(SQUARES[1]):])
    if any(v == src for k, v in out.items() if k != "full"):
        raise RuntimeError("a part to take out was not found in the source")
    return out


def build(work: Path) -> dict:
    """One shared library per form, built in parallel."""
    procs = {}
    for name, text in forms((CSRC / "retrieve_topk.cu").read_text()).items():
        d = work / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "retrieve_topk.cu").write_text(text)
        (d / "ptx_helpers.cuh").write_text((CSRC / "ptx_helpers.cuh").read_text())
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.ARCH, "-std=c++17", "-O3", "-Xcompiler",
             "-fPIC", "-shared", "-o", str(d / "lib.so"),
             str(d / "retrieve_topk.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(work / name / "lib.so"))
        libs[name] = _build.bind(_Entries(lib))  # others' entries: placeholders
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_retrieval_parts: no CUDA device", file=sys.stderr)
        return 2
    libs = build(ROOT / "build" / "retrieval_parts")
    gen = torch.Generator(device="cuda").manual_seed(0)
    catalog = torch.randn(N, D, device="cuda", generator=gen)
    codes, scales = quantize_rows(catalog)
    flush = torch.empty((128 << 20) // 4, device="cuda")
    sms = sm_count(catalog.device)
    stream = torch.cuda.current_stream().cuda_stream

    def call(lib, int8, users):
        b = users.shape[0]
        plan = retrieval_plan(b, N, D, 1 if int8 else 4, sms)
        part = torch.empty(2, b, plan.shares, K, device="cuda",
                           dtype=torch.int32)
        out_s = torch.empty(b, K, device="cuda")
        out_i = torch.empty(b, K, device="cuda", dtype=torch.int64)
        tail = (plan.users_per_group, plan.shares, plan.rows_per_share,
                plan.tile_rows, stream)
        if int8:
            err = lib.unirec_retrieve_topk_int8(
                users.data_ptr(), codes.data_ptr(), scales.data_ptr(),
                part[0].data_ptr(), part[1].data_ptr(), out_s.data_ptr(),
                out_i.data_ptr(), b, N, D, K, *tail)
        else:
            err = lib.unirec_retrieve_topk(
                users.data_ptr(), catalog.data_ptr(), part[0].data_ptr(),
                part[1].data_ptr(), out_s.data_ptr(), out_i.data_ptr(), b, N,
                D, K, 1, *tail)
        _build.check(err, "retrieve_topk")

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for int8 in (False, True):
        for b in (8, 64):
            users = torch.randn(b, D, device="cuda", generator=gen)
            cells = []
            for name, lib in libs.items():
                ms = chip_smoke.retrieval_device_ms(
                    lambda: call(lib, int8, users), ITERS, flush)[1]
                cells.append(f"{name} {ms['topk_share_kernel']:.4f} + "
                             f"{ms['topk_merge_kernel']:.4f}")
            print(f"{'B11' if int8 else 'K2'} users={b}: share + merge ms, "
                  + " | ".join(cells), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
