"""K2 and B11 of two checkouts on one card: device ms a call and the kernels
each call launches, at 8 and 64 users over the 20,000 x 1,024 catalog, k 20.

    python3 scripts/compare_retrieval_builds.py OTHER_ROOT

Unpack the other commit under ``build/`` with ``git archive``. The script
runs other, this, this, other, each in an interpreter of its own that imports
that tree's ``unirec_tpu_torch`` (its kernels built into that tree's
``build/``). A call's device ms is the sum of every kernel it launches (the
wrapper's normalisation passes too), each kernel's device time averaged over
its recorded launches in 20 calls (``torch.profiler``), once with L2 flushed
before each call (a 128 MB buffer written and read; the flush's own kernels,
named by a flush-only run, are left out) and once warm. Each run prints a
JSON line; the last line compares the trees' ids. Inputs come from seed 0,
the same in every run.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = r'''
import hashlib, json, sys
sys.path.insert(0, sys.argv[1])
import torch
from torch.profiler import ProfilerActivity, profile
from unirec_tpu_torch.ops.quantization import quantize_rows, retrieve_top_k_int8
from unirec_tpu_torch.ops.ranking import retrieve_top_k

N, D, K, ITERS = 20_000, 1_024, 20, 20
torch.backends.cuda.matmul.allow_tf32 = False
gen = torch.Generator(device="cuda").manual_seed(0)
catalog = torch.randn(N, D, device="cuda", generator=gen)
codes, scales = quantize_rows(catalog)
users = {b: torch.randn(b, D, device="cuda", generator=gen) for b in (8, 64)}
flush = torch.empty((128 << 20) // 4, device="cuda")


def kernels(fn, iters, flushed):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if flushed:
                flush.fill_(1.0)
                flush.sum()
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            t = getattr(ev, "self_device_time_total", None)
            if t is None:
                t = getattr(ev, "self_cuda_time_total", 0)
            if t > 0 and ev.count:
                out[ev.key] = (t / 1e3 / ev.count, ev.count / iters)
    return out


kernels(lambda: torch.ones(1, device="cuda"), 2, False)  # profiler warm-up
flush_names = set(kernels(lambda: None, 5, True))
res, ids = {}, hashlib.sha256()
for name, call in (("K2", lambda u: retrieve_top_k(u, catalog, k=K)),
                   ("B11", lambda u: retrieve_top_k_int8(u, codes, scales, k=K))):
    for b, u in users.items():
        s, i = call(u)
        ids.update(i.cpu().numpy().tobytes())
        row = {}
        for mode in ("cold", "warm"):
            ks = kernels(lambda: call(u), ITERS, mode == "cold")
            ks = {n: v for n, v in ks.items() if n not in flush_names}
            row[mode] = sum(ms * max(1, round(n)) for ms, n in ks.values())
            row["launches"] = sum(c for _, c in ks.values())
            row["kernels"] = sorted(n.split("(")[0][-40:] for n in ks)
        res[f"{name} users={b}"] = row
print(json.dumps({"root": sys.argv[1], "ids": ids.hexdigest(), "res": res}))
'''


def run(root: Path) -> dict:
    out = subprocess.run([sys.executable, "-c", CHILD, str(root)],
                         capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"{root}: {out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    other = Path(sys.argv[1]).resolve()
    runs = [run(root) for root in (other, ROOT, ROOT, other)]
    for r in runs:
        print(json.dumps(r), flush=True)
    for key in runs[0]["res"]:
        print(key + ": " + ", ".join(
            f"{'this' if r['root'] == str(ROOT) else 'other'} cold "
            f"{r['res'][key]['cold']:.4f} warm {r['res'][key]['warm']:.4f} "
            f"({r['res'][key]['launches']:g} launches)" for r in runs))
    print(json.dumps({"same_ids": len({r["ids"] for r in runs}) == 1}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
