"""B13 and B14 (forward and backward) of two checkouts of the port on one
card: outputs bit for bit and times side by side, at the user stage's shape
(64 users, 64 queries over 1,600 memory rows, 16 heads of 64; ~15% masked
keys, one user masked whole) in float32 and bf16.

    python3 scripts/compare_flash_cross_builds.py OTHER_ROOT

OTHER_ROOT is another checkout of the repository (for example the parent
commit, unpacked with ``git archive``).  Each checkout runs in its own
interpreter, which builds that checkout's kernels into its own ``build/``
directory; the order is other, this, this, other.  Every run makes the same
inputs from seed 0, hashes each output's bytes and times each kernel with
CUDA events (20 launches after 3 warm-ups, bf16).  The script fails unless
all four runs give the same hashes; it prints the card's name and power
limit and one JSON line per run.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, LQ, LKV, H, D = 64, 64, 1600, 16, 1024


def worker(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    from unirec_tpu_torch.ops import attention as pa
    from unirec_tpu_torch.ops import flash_vjp as fl

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    hashes, times = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        q, do = (torch.randn(B, LQ, D, device="cuda", generator=gen)
                 .to(dtype) for _ in range(2))
        k3, v3 = (torch.randn(B, LKV, D, device="cuda", generator=gen)
                  .to(dtype) for _ in range(2))
        mask = (torch.rand(B, LKV, device="cuda", generator=gen) > 0.15
                ).float()
        mask[1] = 0.0
        bias = ((1.0 - mask) * -1e9)[:, None, None, :]
        bias32 = pa.key_bias(bias, B, LKV, q.device)
        qh, kh, vh = (pa.split_heads(t, H) for t in (q, k3, v3))
        o, m, l = fl.flash_cross_fwd(q, k3, v3, bias32, H)
        dsum = fl.attention_dsum(do, o, H).contiguous()
        runs = {
            "b13": lambda: (pa.flash_cross_attention(qh, kh, vh, bias),),
            "b14_fwd": lambda: fl.flash_cross_fwd(q, k3, v3, bias32, H),
            "b14_bwd": lambda: fl.flash_cross_bwd(q, k3, v3, bias32, do, m,
                                                  l, dsum, H),
        }
        for name, run in runs.items():
            digest = hashlib.sha256()
            for t in run():
                digest.update(t.contiguous().view(torch.uint8).cpu().numpy()
                              .tobytes())
            hashes[f"{name} {dtype}"] = digest.hexdigest()[:16]
            if dtype == torch.bfloat16:
                for _ in range(3):
                    run()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(20):
                    run()
                end.record()
                torch.cuda.synchronize()
                times[name] = start.elapsed_time(end) / 20
    return {"root": root, "hashes": hashes, "ms": times}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("other", help="root of the other checkout")
    parser.add_argument("--worker", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker:
        print(json.dumps(worker(os.path.abspath(args.other))))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    other = os.path.abspath(args.other)
    results = []
    for root in (other, HERE, HERE, other):
        env = {k: v for k, v in os.environ.items()
               if k != "UNIREC_TPU_TORCH_BUILD_DIR"}
        out = subprocess.run([sys.executable, os.path.abspath(__file__), root,
                              "--worker"], cwd=root, env=env,
                             capture_output=True, text=True)
        if out.returncode:
            print(out.stdout + out.stderr, file=sys.stderr)
            return 1
        results.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(results[-1]), flush=True)
    same = all(r["hashes"] == results[0]["hashes"] for r in results)
    print(f"outputs identical across the four runs: {same}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
