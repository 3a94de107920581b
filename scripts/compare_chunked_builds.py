"""The chunked form (head dims above 256) of two checkouts of the port on one
card: the 2-head and 1-head user steps and the chunked kernels timed side by
side, the outputs compared.

    python3 scripts/compare_chunked_builds.py OTHER_ROOT

OTHER_ROOT is another checkout of the repository (for example the parent
commit, unpacked with ``git archive``).  Each checkout runs in its own
interpreter, which builds that checkout's kernels into its own ``build/``
directory; the order is other, this, this, other.  Every run makes the same
inputs from seed 0 and measures in bf16 and float32 (CUDA events over 20
launches after 3 warm-ups):

  - B13, B14 (forward, backward) and B14p (forward, backward) at 8 users
    (and in bf16 at 64) (64 queries over 1,600 memory rows, 2 heads of 512
    and of 320; ~15% masked keys, user 1 masked whole), at 8 users in one
    head of 1024, B13 (bf16) or B13 and B14 (float32) at 8 users in one
    head of 1536, float32 also in one head of 2048 and in 2 heads of 256;
  - K1 and B7b's dq and dk / dv at B 2, L 512, 4 query / 2 key heads (rows
    of 512 and 301 keys) at head dims 320, 512 and 768 (bf16) or 256, 320
    and 512 (float32);
  - one step of the user trainer at ``UserQFormerConfig(num_attention_heads
    =2)`` and at one head (of 1024), ``--flash --fused``, batch 64, seq 50,
    on random item tokens (bf16 compute, float32 masters; 10 batches made
    once a run and shared by its steps), and the 2-head
    step at float32 compute: host clock over 5 synchronised steps after 2,
    the forward + backward and the optimizer split over 3 more, peak
    memory, and the device time, B14's share of it and the idle share of one
    step under ``torch.profiler``.

It hashes the outputs of every kernel run and saves them.  The script fails
unless every output's hash is the same in the two runs of each checkout;
the bf16 hashes and, of float32, those of what both checkouts run in the
same form (``same_form``: every chunked form, and K1 at hd 256) are the
same in all four runs (the float32 B13, B14, B14p and B7b at hd 256 are
3xTF32 on tensor cores here and may be the scalar form in the other
checkout); and this checkout's outputs
agree with the other's within chip_smoke.py's kernel gates (max|d| at most
2e-2 of max|other| in bf16 and 1e-5 in float32, per-row cosine at least
0.9999 where the other's row is nonzero; B7b's dq over the rows of at least
1e-3 of its largest row norm).  It prints the card's name and power limit
and one JSON line per run.
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
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LQ, LKV, H, HD = 64, 1600, 2, 512
CAUSAL = dict(B=2, L=512, HQ=4, HKV=2, LENGTHS=(512, 301))
USERS, STEP_BATCH, STEP_SEQ = (8, 64), 64, 50
# chip_smoke.py's kernel gates: max|d| / max|other| by dtype, row cosine
KERNEL_TOL, KERNEL_COS = {"bfloat16": 2e-2, "float32": 1e-5}, 0.9999


def same_form(key: str) -> bool:
    """Whether the run ``key`` ("name dtype") takes the same form in both
    checkouts, so that its bits must agree: every bf16 run and every
    float32 run but those at hd 256 other than K1 (the float32 B13, B14,
    B14p and B7b up to hd 256 run 3xTF32 on tensor cores here and may run
    the scalar design in the other checkout)."""
    name, dtype = key.split()
    return (dtype.endswith("bfloat16") or "256" not in name
            or name.startswith("k1"))


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


def _cross_runs(gen, b, dtype, h=H, hd=HD):
    """B13, B14 and B14p at ``b`` users in ``h`` heads of ``hd``: name -> a
    call returning outputs."""
    import torch

    from unirec_tpu_torch.ops import attention as pa
    from unirec_tpu_torch.ops import flash_vjp as fl

    d = h * hd
    q, do = (torch.randn(b, LQ, d, device="cuda", generator=gen).to(dtype)
             for _ in range(2))
    k3, v3 = (torch.randn(b, LKV, d, device="cuda", generator=gen)
              .to(dtype) for _ in range(2))
    mask = (torch.rand(b, LKV, device="cuda", generator=gen) > 0.15).float()
    mask[1] = 0.0
    bias = ((1.0 - mask) * -1e9)[:, None, None, :]
    bias32 = pa.key_bias(bias, b, LKV, q.device)
    qh, kh, vh, doh = (pa.split_heads(t, h) for t in (q, k3, v3, do))
    o, m, l = fl.flash_cross_fwd(q, k3, v3, bias32, h)
    dsum = fl.attention_dsum(do, o, h).contiguous()
    qp, kp, vp, dop = (t.contiguous() for t in (qh, kh, vh, doh))
    op, mp, lp = fl.flash_cross_vjp_fwd(qp, kp, vp, bias32)
    dsum_p = (dop.float() * op).sum(-1).transpose(1, 2).contiguous()
    return {
        "b13": lambda: (pa.flash_cross_attention(qh, kh, vh, bias),),
        "b14_fwd": lambda: fl.flash_cross_fwd(q, k3, v3, bias32, h),
        "b14_bwd": lambda: fl.flash_cross_bwd(q, k3, v3, bias32, do, m, l,
                                              dsum, h),
        "b14p_fwd": lambda: fl.flash_cross_vjp_fwd(qp, kp, vp, bias32),
        "b14p_bwd": lambda: fl.flash_cross_vjp_bwd(qp, kp, vp, bias32, dop,
                                                   mp, lp, dsum_p),
    }


def _causal_runs(gen, dtype, hd=HD):
    """K1 and B7b at CAUSAL's shape, head dim ``hd``."""
    import torch

    from unirec_tpu_torch.ops import flash_causal as fc

    b, l, hq, hkv = (CAUSAL[x] for x in ("B", "L", "HQ", "HKV"))
    q, do = (torch.randn(b, l, hq * hd, device="cuda", generator=gen)
             .to(dtype) for _ in range(2))
    k, v = (torch.randn(b, l, hkv * hd, device="cuda", generator=gen)
            .to(dtype) for _ in range(2))
    lengths = torch.tensor(CAUSAL["LENGTHS"], device="cuda")
    mask = (torch.arange(l, device="cuda")[None] < lengths[:, None]).float()
    # the backward's (m, l, dsum) from the plain forward: the same inputs in
    # both checkouts whatever form their K1 takes
    o, m, den = fc.flash_causal_attention_fwd_plain(q.float(), k.float(),
                                                    v.float(), mask, hq, hkv)
    dsum = fc.attention_dsum(do, o.to(dtype), hq).contiguous()
    args = (q, k, v, mask, do, m, den, dsum, hq, hkv)
    return {
        "k1": lambda: fc._k1(q, k, v, mask, hq, hkv, stats=True),
        "b7b_dq": lambda: (fc.flash_causal_bwd_dq(*args),),
        "b7b_dkv": lambda: fc.flash_causal_bwd_dkv(*args),
    }


def _step_batches(n_batches: int = 10) -> list:
    """The user steps' random batches (batch 64, seq 50, 32 item tokens of
    1024), made once a run in float32 and shared by its steps."""
    import numpy as np

    rng = np.random.default_rng(0)
    n, s = STEP_BATCH, STEP_SEQ
    batches = []
    for _ in range(n_batches):
        lengths = rng.integers(10, s + 1, n)
        seq_mask = (np.arange(s)[None] < lengths[:, None]).astype(np.float32)
        tokens = rng.standard_normal((n, s, 32, 1024), dtype=np.float32)
        tokens *= 0.1 * seq_mask[..., None, None]
        batches.append({
            "item_tokens": tokens,
            "timestamps": np.cumsum(rng.integers(1, 1000, (n, s)), 1)
            .astype(np.float32) * seq_mask,
            "coordinates": np.zeros((n, s, 2), np.float32),
            "seq_mask": seq_mask,
            "target_tokens": rng.standard_normal((n, 32, 1024),
                                                 dtype=np.float32) * 0.1,
            "sample_weight": np.ones((n,), np.float32)})
    return batches


def _user_step(batches, heads: int = H, dtype: str = "bfloat16") -> dict:
    """ms per step of the ``heads``-head --flash --fused user step at
    ``dtype`` compute over ``batches`` (``_step_batches``), its split, peak
    memory, device time, B14's share and idle share."""
    import dataclasses

    import numpy as np
    import torch

    from unirec_tpu_torch.configs import (
        OptimizerConfig,
        TrainConfig,
        UserQFormerConfig,
    )
    from unirec_tpu_torch.train.user_qformer import (
        UserQFormerTrainer,
        make_train_step,
    )

    uc = dataclasses.replace(
        UserQFormerConfig(num_item_tokens_to_predict=32,
                          input_embedding_dim=1024, dropout=0.0),
        num_attention_heads=heads, flash_training=True, fused_training=True)
    tc = TrainConfig(batch_size=STEP_BATCH, seed=0,
                     optimizer=OptimizerConfig(learning_rate=5e-5))
    st = UserQFormerTrainer(uc, tc, STEP_SEQ, dtype=dtype,
                            device="cuda").init_state()
    step = make_train_step(st.model, seed=0)
    for b in batches[:2]:
        st, _ = step(st, b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for b in batches[2:7]:
        st, m = step(st, b)
    loss = m["loss"].item()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 5 * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    real, marks = st.optimizer.step, []

    def apply(grads):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        real(grads)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    st.optimizer.step = apply
    fb, op = [], []
    for b in batches[7:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(st, b)
        fb.append((marks[-2] - t0) * 1e3)
        op.append((marks[-1] - marks[-2]) * 1e3)
    del st.optimizer.step
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(st, batches[0])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    device = {}  # the device kernels' own rows, as chip_smoke.py reads them
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0)
        if t > 0:
            device[e.key] = device.get(e.key, 0.0) + t / 1e3
    total = sum(device.values())
    b14 = sum(t for k, t in device.items() if any(
        n in k for n in ("flash_cross_fwd", "flash_cross_bwd", "chunk_fwd",
                         "chunk_bwd_rows", "chunk_dkv_sum", "chunk_fwd_merge",
                         "fwd_tf32", "bwd_rows_tf32")))
    del st, step
    torch.cuda.empty_cache()
    return {"ms": ms, "fwd_bwd_ms": float(np.median(fb)),
            "optimizer_ms": float(np.median(op)), "peak_gb": peak,
            "loss": loss, "device_ms": total, "wall_ms": wall,
            "idle": max(0.0, 1 - total / wall) if total else None,
            "b14_device_ms": b14}


def worker(root: str, save: str) -> dict:
    sys.path.insert(0, root)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    hashes, times = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        users = USERS if dtype == torch.bfloat16 else USERS[:1]
        groups = {f"{name}_{b}users": run for b in users
                  for name, run in _cross_runs(gen, b, dtype).items()}
        groups.update(_causal_runs(gen, dtype))
        groups.update({f"{name}_2x320_{b}users": run for b in users
                       for name, run in
                       _cross_runs(gen, b, dtype, hd=320).items()})
        groups.update({f"{name}_hd320": run for name, run in
                       _causal_runs(gen, dtype, 320).items()})
        groups.update({f"{name}_1x1024_8users": run for name, run in
                       _cross_runs(gen, 8, dtype, 1, 1024).items()})
        if dtype == torch.bfloat16:  # the cluster forms' shapes
            groups["b13_1x1536_8users"] = _cross_runs(gen, 8, dtype, 1,
                                                      1536)["b13"]
            groups.update({f"{name}_hd768": run for name, run in
                           _causal_runs(gen, dtype, 768).items()})
        else:  # 6 and 8 chunks, and hd 256, which is not chunked
            for hd in (1536, 2048):
                runs = _cross_runs(gen, 8, dtype, 1, hd)
                groups.update({f"{name}_1x{hd}_8users": runs[name]
                               for name in ("b13", "b14_fwd", "b14_bwd")})
            groups.update({f"{name}_2x256_8users": run for name, run in
                           _cross_runs(gen, 8, dtype, hd=256).items()})
            groups.update({f"{name}_hd256": run for name, run in
                           _causal_runs(gen, dtype, 256).items()})
        kind = str(dtype)[6:]
        for name, run in groups.items():
            digest = hashlib.sha256()
            outs = [t.cpu() for t in run()]
            for t in outs:
                digest.update(t.contiguous().view(torch.uint8).numpy()
                              .tobytes())
            hashes[f"{name} {dtype}"] = digest.hexdigest()[:16]
            torch.save(outs, os.path.join(save, f"{name} {kind}.pt"))
            times[name if dtype == torch.bfloat16 else f"{name} {kind}"] = (
                _ms(run))
        del groups
        torch.cuda.empty_cache()
    batches = _step_batches()
    return {"root": root, "hashes": hashes, "ms": times,
            "user_step": _user_step(batches),
            "user_step_1x1024": _user_step(batches, heads=1),
            "user_step_float32": _user_step(batches, dtype="float32")}


def compare(results, saved) -> bool:
    """Every output's bits equal within each checkout; those of
    ``same_form`` equal across checkouts; this checkout's outputs against
    the other's at the kernel gates."""
    import torch

    hashes = [r["hashes"] for r in results]
    repeat = hashes[0] == hashes[3] and hashes[1] == hashes[2]
    kept = [{k: v for k, v in h.items() if same_form(k)} for h in hashes]
    same = all(h == kept[0] for h in kept)
    print(f"outputs identical within each checkout: {repeat}")
    print(f"bf16 outputs, float32 chunked forms and float32 K1 at hd 256 "
          f"identical across the four runs: {same}")
    for key in sorted(k for k in hashes[0] if not same_form(k)):
        print(f"  {key}: this {hashes[1][key]}, other {hashes[0][key]}")
    ok = repeat and same
    for name in sorted(os.listdir(os.path.join(saved, "0"))):
        ref = torch.load(os.path.join(saved, "0", name))
        got = torch.load(os.path.join(saved, "1", name))
        tol = KERNEL_TOL[name[:-3].split()[1]]
        for i, (g, r) in enumerate(zip(got, ref)):
            a, b = g.float(), r.float()
            rel = ((a - b).abs().max() / b.abs().max()).item()
            a2, b2 = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
            live = b2.abs().amax(-1) > 0
            if name.startswith("b7b_dq"):
                # rows over one or a few keys: their exact dq is 0 or a sum
                # of nearly cancelling terms, both sides mostly rounding
                # noise (held by max|d| alone)
                norm = b2.norm(dim=-1)
                live &= norm >= 1e-3 * norm.max()
            cos = torch.nn.functional.cosine_similarity(
                a2[live], b2[live], dim=-1).min().item()
            good = rel <= tol and cos >= KERNEL_COS
            print(f"{name[:-3]} output {i}: max|d| {rel:.3e} of "
                  f"max|other| (tol {tol:g}), min row cosine "
                  f"{cos:.7f} (tol {KERNEL_COS})")
            ok = ok and good
    return ok


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
    saved = tempfile.mkdtemp(prefix="compare_chunked_")
    try:
        for i, root in enumerate((other, HERE, HERE, other)):
            env = {k: v for k, v in os.environ.items()
                   if k != "UNIREC_TPU_TORCH_BUILD_DIR"}
            save = os.path.join(saved, str(i))
            os.makedirs(save)
            t0 = time.perf_counter()
            out = subprocess.run([sys.executable, os.path.abspath(__file__),
                                  root, "--worker", save], cwd=root, env=env,
                                 capture_output=True, text=True)
            if out.returncode:
                print(out.stdout + out.stderr, file=sys.stderr)
                return 1
            results.append(json.loads(out.stdout.strip().splitlines()[-1]))
            results[-1]["seconds"] = time.perf_counter() - t0
            print(json.dumps(results[-1]), flush=True)
        ok = compare(results, saved)
    finally:
        shutil.rmtree(saved, ignore_errors=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
