"""B13 and B14 (forward and backward) of two checkouts of the port on one
card: outputs compared and times side by side, at the user stage's shape
(64 users, 64 queries over 1,600 memory rows, 16 heads of 64; ~15% masked
keys, one user masked whole) in float32 and bf16.

    python3 scripts/compare_flash_cross_builds.py OTHER_ROOT

OTHER_ROOT is another checkout of the repository (for example the parent
commit, unpacked with ``git archive``).  Each checkout runs in its own
interpreter, which builds that checkout's kernels into its own ``build/``
directory; the order is other, this, this, other.  Every run makes the same
inputs from seed 0, hashes each output's bytes, saves the bf16 outputs and
times each kernel with CUDA events (20 launches after 3 warm-ups, bf16).
The script fails unless the float32 hashes are the same in all four runs
(the float32 kernels are the scalar design in both), the bf16 hashes are
the same in the two runs of each checkout, and this checkout's bf16 outputs
agree with the other's within chip_smoke.py's kernel gates (max|d| at most
KERNEL_TOL of max|ref|, per-row cosine at least KERNEL_COS where the other's
row is nonzero; the bf16 designs may differ, so their bits may).  It prints
the card's name and power limit and one JSON line per run.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, LQ, LKV, H, D = 64, 64, 1600, 16, 1024
KERNEL_TOL, KERNEL_COS = 2e-2, 0.9999  # chip_smoke.py's bf16 kernel gates


def worker(root: str, save: str) -> dict:
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
                torch.save([t.cpu() for t in run()],
                           os.path.join(save, f"{name}.pt"))
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
    parser.add_argument("--worker", metavar="SAVE_DIR",
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker:
        print(json.dumps(worker(os.path.abspath(args.other), args.worker)))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    other = os.path.abspath(args.other)
    results = []
    saved = tempfile.mkdtemp(prefix="compare_flash_cross_")
    try:
        for i, root in enumerate((other, HERE, HERE, other)):
            env = {k: v for k, v in os.environ.items()
                   if k != "UNIREC_TPU_TORCH_BUILD_DIR"}
            save = os.path.join(saved, str(i))
            os.makedirs(save)
            out = subprocess.run([sys.executable, os.path.abspath(__file__),
                                  root, "--worker", save], cwd=root, env=env,
                                 capture_output=True, text=True)
            if out.returncode:
                print(out.stdout + out.stderr, file=sys.stderr)
                return 1
            results.append(json.loads(out.stdout.strip().splitlines()[-1]))
            print(json.dumps(results[-1]), flush=True)
        ok = compare(results, saved)
    finally:
        shutil.rmtree(saved, ignore_errors=True)
    return 0 if ok else 1


def compare(results, saved) -> bool:
    """float32 bits equal in all four runs; bf16 bits equal within each
    checkout; this checkout's bf16 outputs against the other's."""
    import torch

    f32 = [{k: v for k, v in r["hashes"].items() if "float32" in k}
           for r in results]
    b16 = [{k: v for k, v in r["hashes"].items() if "bfloat16" in k}
           for r in results]
    same_f32 = all(h == f32[0] for h in f32)
    repeat_b16 = b16[0] == b16[3] and b16[1] == b16[2]
    print(f"float32 outputs identical across the four runs: {same_f32}")
    print(f"bf16 outputs identical within each checkout: {repeat_b16}")
    ok = same_f32 and repeat_b16
    for name in sorted(os.listdir(os.path.join(saved, "0"))):
        ref = torch.load(os.path.join(saved, "0", name))
        got = torch.load(os.path.join(saved, "1", name))
        for i, (g, r) in enumerate(zip(got, ref)):
            a, b = g.float(), r.float()
            rel = ((a - b).abs().max() / b.abs().max()).item()
            a2, b2 = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
            live = b2.abs().amax(-1) > 0
            cos = torch.nn.functional.cosine_similarity(
                a2[live], b2[live], dim=-1).min().item()
            good = rel <= KERNEL_TOL and cos >= KERNEL_COS
            print(f"bf16 {name[:-3]} output {i}: max|d| {rel:.3e} of "
                  f"max|other| (tol {KERNEL_TOL:g}), min row cosine "
                  f"{cos:.7f} (tol {KERNEL_COS})")
            ok = ok and good
    return ok


if __name__ == "__main__":
    sys.exit(main())
