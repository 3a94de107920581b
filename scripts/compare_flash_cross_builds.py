"""B13, B14 (forward and backward) and B7b of two checkouts of the port on
one card: outputs compared and times side by side, B13 / B14 at the user
stage's shape (64 users, 64 queries over 1,600 memory rows, 16 heads of 64;
~15% masked keys, one user masked whole) in float32 and bf16, K1 and B7b's
dq and dk / dv at the joint training shape (B 8, L 512, 16 query / 8 key
heads of 128, right-padded rows) in float32 and bf16; and the train CLI's
default user step (``UserQFormerConfig()``: 16 heads of 64, float32
compute, ``--flash``, batch 64, seq 50; ``compare_chunked_builds._user_step``:
ms per step, the split, peak memory, B14's device ms and the idle share).

    python3 scripts/compare_flash_cross_builds.py OTHER_ROOT

OTHER_ROOT is another checkout of the repository (for example the parent
commit, unpacked with ``git archive``).  Each checkout runs in its own
interpreter, which builds that checkout's kernels into its own ``build/``
directory; the order is other, this, this, other.  Every run makes the same
inputs from seed 0, hashes each output's bytes, saves the outputs and times
each kernel with CUDA events (20 launches after 3 warm-ups).  The script
fails unless every output's hash is the same in the two runs of each
checkout; the bf16 hashes and K1's float32 hashes (designs this checkout
shares with the parent) are the same in all four runs; this checkout's
outputs agree with the other's within chip_smoke.py's kernel gates (max|d|
at most KERNEL_TOL of max|ref|, per-row cosine at least KERNEL_COS where
the other's row is nonzero); the float32 outputs of B13, B14 and B7b (3xTF32
on tensor cores here, maybe the scalar design in the other checkout, so
their bits may differ) are no farther from a float64 evaluation of their
formula (``f64_cross``, ``f64_causal``) than the other checkout's, to
REDESIGN_TOL of max|ref|, and no farther from it than F64_TOL; and each bf16 kernel of at least 0.2 ms takes
within 1% of the other's time (the faster of each checkout's two runs).
The backward's (m, l, dsum) come from the plain forward in every run.  It prints
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
CAUSAL = dict(B=8, L=512, HQ=16, HKV=8, HD=128)
# chip_smoke.py's kernel gates: max|d| / max|other| by dtype, row cosine
KERNEL_TOL, KERNEL_COS = {"bfloat16": 2e-2, "float32": 1e-5}, 0.9999
# a redesigned float32 output is no farther from the float64 formula than
# the other checkout's, to REDESIGN_TOL of max|ref|, and at most F64_TOL of
# max|ref| from it (on an H100 the 3xTF32 kernels measured 3.9e-7 to
# 1.15e-6, the parent's scalar kernels up to 1.68e-6)
REDESIGN_TOL, F64_TOL = 1e-6, 1.5e-6
TIME_TOL, TIME_MIN_MS = 0.01, 0.2  # bf16 times unchanged: within 1% from 0.2 ms


def same_bits(key: str) -> bool:
    """Whether the run ``key`` ("name dtype") must give the other
    checkout's bits: every bf16 run and K1's float32 forward."""
    name, dtype = key.split()
    return dtype.endswith("bfloat16") or name == "k1"


def _ms(run, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        run()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def f64_cross(q, k3, v3, bias32, do, m, l, dsum, h):
    """B14's float64 formula on float32 merged-head inputs: (o, [dq, dk,
    dv]), the forward's own (m, l) for o and the caller's (m, l, dsum) for
    the backward.  The score is the exact dot product rounded as the
    kernels round it: float32 (q . k) * scale, then + bias in float32 (the
    masked user's scores all round to -1e9, as in every float32 version)."""
    import torch

    from unirec_tpu_torch.ops import attention as pa
    from unirec_tpu_torch.ops import flash_vjp as fl

    qh, kh, vh, doh = (fl._heads(t, h).double() for t in (q, k3, v3, do))
    scale = pa.sm_scale(qh.shape[-1])
    s = (((qh @ kh.transpose(-1, -2)) * scale).float()
         + bias32[:, None, None, :]).double()
    m64 = s.amax(-1, keepdim=True).clamp_min(-1e9)
    p = torch.exp(s - m64)
    l64 = p.sum(-1, keepdim=True)
    o = pa.merge_heads(p @ vh / torch.where(l64 == 0, 1.0, l64))
    m_h, l_h = (t.double().transpose(1, 2)[..., None] for t in (m, l))
    p = torch.exp(s - m_h) / torch.where(l_h == 0, 1.0, l_h)
    ds = p * (doh @ vh.transpose(-1, -2) - dsum.double().transpose(1, 2)
              [..., None]) * scale
    return o, [pa.merge_heads(g) for g in (ds @ kh, ds.transpose(-1, -2) @ qh,
                                           p.transpose(-1, -2) @ doh)]


def f64_causal(q, k, v, mask, do, m, l, dsum, hq, hkv):
    """B7b's float64 formula on float32 merged-head inputs from (m, l,
    dsum): [dq, dk, dv], the score float32 (q . k) * scale of the exact dot
    product, dk and dv summed over each group's query heads."""
    import torch

    from unirec_tpu_torch.ops import attention as pa
    from unirec_tpu_torch.ops import flash_causal as fc

    b, seq, _ = q.shape
    qh, kh, vh, hd = fc._split(q, k, v, hq, hkv)
    qh, kh, vh = (t.double() for t in (qh, kh, vh))
    doh = do.reshape(b, seq, hq, hd).transpose(1, 2).double()
    allowed = (torch.tril(torch.ones(seq, seq, device=q.device))[None, None]
               * mask[:, None, None, :]).double()
    scale = pa.sm_scale(hd)
    s = (((qh @ kh.transpose(-1, -2)) * scale).float().double()
         + (1.0 - allowed) * -1e9)
    m_h, l_h = (t.double().transpose(1, 2)[..., None] for t in (m, l))
    p = torch.exp(s - m_h) / torch.where(l_h == 0, 1.0, l_h)
    ds = p * (doh @ vh.transpose(-1, -2) - dsum.double().transpose(1, 2)
              [..., None]) * scale

    def kv(g):
        g = g.reshape(b, hkv, hq // hkv, seq, hd).sum(2)
        return g.transpose(1, 2).reshape(b, seq, hkv * hd)

    return [(ds @ kh).transpose(1, 2).reshape(b, seq, hq * hd),
            kv(ds.transpose(-1, -2) @ qh), kv(p.transpose(-1, -2) @ doh)]


def _causal_runs(gen, dtype):
    """K1 and B7b at CAUSAL's shape, row lengths drawn from gen (key 0
    valid), the backward's (m, l, dsum) from the plain forward: (name -> a
    call returning outputs, and in float32 name -> float64 references)."""
    import torch

    from unirec_tpu_torch.ops import flash_causal as fc

    b, l, hq, hkv, hd = (CAUSAL[x] for x in ("B", "L", "HQ", "HKV", "HD"))
    lengths = torch.randint(1, l + 1, (b,), device="cuda", generator=gen)
    lengths[-1] = l
    mask = (torch.arange(l, device="cuda")[None] < lengths[:, None]).float()
    q, k, v, do = (torch.randn(b, l, h * hd, device="cuda", generator=gen)
                   .to(dtype) for h in (hq, hkv, hkv, hq))
    o, m, den = fc.flash_causal_attention_fwd_plain(q.float(), k.float(),
                                                    v.float(), mask, hq, hkv)
    dsum = fc.attention_dsum(do, o.to(dtype), hq).contiguous()
    args = (q, k, v, mask, do, m, den, dsum, hq, hkv)
    runs = {
        "k1": lambda: fc._k1(q, k, v, mask, hq, hkv, stats=True),
        "b7b_dq": lambda: (fc.flash_causal_bwd_dq(*args),),
        "b7b_dkv": lambda: fc.flash_causal_bwd_dkv(*args),
    }
    refs = {}
    if dtype == torch.float32:
        dq, dk, dv = f64_causal(*args)
        refs = {"b7b_dq": [dq], "b7b_dkv": [dk, dv]}
    return runs, refs


def worker(root: str, save: str) -> dict:
    sys.path.insert(0, root)
    import torch

    from unirec_tpu_torch.ops import attention as pa
    from unirec_tpu_torch.ops import flash_vjp as fl

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    hashes, times, f64 = {}, {}, {}
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
        # the backward's (m, l, dsum) from the plain forward: the same
        # inputs in both checkouts whatever their forward kernel gives
        o, m, l = fl.flash_cross_fwd_plain(q, k3, v3, bias32, H)
        dsum = fl.attention_dsum(do, o, H).contiguous()
        runs = {
            "b13": lambda: (pa.merge_heads(pa.flash_cross_attention(
                qh, kh, vh, bias)),),
            "b14_fwd": lambda: fl.flash_cross_fwd(q, k3, v3, bias32, H),
            "b14_bwd": lambda: fl.flash_cross_bwd(q, k3, v3, bias32, do, m,
                                                  l, dsum, H),
        }
        refs = {}
        if dtype == torch.float32:
            o64, grads = f64_cross(q, k3, v3, bias32, do, m, l, dsum, H)
            refs = {"b13": [o64], "b14_fwd": [o64], "b14_bwd": grads}
        causal, causal_refs = _causal_runs(gen, dtype)
        runs.update(causal)
        refs.update(causal_refs)
        kind = str(dtype)[6:]
        for name, run in runs.items():
            digest = hashlib.sha256()
            got = run()
            if name in refs:  # the outputs' distance from float64
                f64[f"{name} {kind}"] = [
                    ((g.double() - r).abs().max() / r.abs().max()).item()
                    for g, r in zip(got, refs[name])]
            outs = [t.cpu() for t in got]
            for t in outs:
                digest.update(t.contiguous().view(torch.uint8).numpy()
                              .tobytes())
            hashes[f"{name} {kind}"] = digest.hexdigest()[:16]
            torch.save(outs, os.path.join(save, f"{name} {kind}.pt"))
            times[f"{name} {kind}"] = _ms(run)
        del q, do, k3, v3, qh, kh, vh, o, m, l, dsum, runs, refs, got
        torch.cuda.empty_cache()
    # the train CLI's default user step: UserQFormerConfig()'s 16 heads of
    # 64 at float32 compute, --flash (compare_chunked_builds' step)
    from compare_chunked_builds import _step_batches, _user_step

    step = _user_step(_step_batches(), heads=H, dtype="float32")
    return {"root": root, "hashes": hashes, "ms": times, "f64": f64,
            "user_step_float32": step}


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
    """Bits equal within each checkout, and across them for ``same_bits``;
    this checkout's outputs against the other's; bf16 times."""
    import torch

    hashes = [r["hashes"] for r in results]
    repeat = hashes[0] == hashes[3] and hashes[1] == hashes[2]
    kept = [{k: v for k, v in h.items() if same_bits(k)} for h in hashes]
    same = all(h == kept[0] for h in kept)
    print(f"outputs identical within each checkout: {repeat}")
    print(f"bf16 outputs and float32 K1 identical across the four runs: "
          f"{same}")
    ok = repeat and same
    for name in sorted(os.listdir(os.path.join(saved, "0"))):
        key = name[:-3]
        ref = torch.load(os.path.join(saved, "0", name))
        got = torch.load(os.path.join(saved, "1", name))
        dtype = key.split()[1]
        tol = KERNEL_TOL[dtype]
        far = [results[i]["f64"].get(key, []) for i in range(4)]
        for i, (g, r) in enumerate(zip(got, ref)):
            if i < len(far[1]):  # a redesigned float32 output
                this, other = max(far[1][i], far[2][i]), max(far[0][i],
                                                             far[3][i])
                good = this <= min(other + REDESIGN_TOL, F64_TOL)
                print(f"{key} output {i}: from the float64 formula "
                      f"{this:.3e} of max|ref| (the other checkout's "
                      f"{other:.3e}, tol its + {REDESIGN_TOL:g} and at most "
                      f"{F64_TOL:g})")
                ok = ok and good
            a, b = g.float(), r.float()
            rel = ((a - b).abs().max() / b.abs().max()).item()
            a2, b2 = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
            live = b2.abs().amax(-1) > 0
            if key.startswith("b7b_dq"):
                # rows over one or a few keys: their exact dq is 0 or a sum
                # of nearly cancelling terms, both sides mostly rounding
                # noise (held by max|d| alone)
                norm = b2.norm(dim=-1)
                live &= norm >= 1e-3 * norm.max()
            cos = torch.nn.functional.cosine_similarity(
                a2[live], b2[live], dim=-1).min().item()
            good = rel <= tol and cos >= KERNEL_COS
            print(f"{key} output {i}: max|d| {rel:.3e} of max|other| (tol "
                  f"{tol:g}), min row cosine {cos:.7f} (tol {KERNEL_COS})")
            ok = ok and good
    for key in sorted(results[0]["ms"]):
        other = min(results[0]["ms"][key], results[3]["ms"][key])
        this = min(results[1]["ms"][key], results[2]["ms"][key])
        line = f"{key}: this {this:.4f} ms, other {other:.4f} ms"
        if key.endswith("bfloat16") and other >= TIME_MIN_MS:
            good = abs(this / other - 1) <= TIME_TOL
            line += f" ({this / other - 1:+.2%}, tol {TIME_TOL:.0%})"
            ok = ok and good
        print(line)
    return ok


if __name__ == "__main__":
    sys.exit(main())
