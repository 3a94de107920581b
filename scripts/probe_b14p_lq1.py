"""The rows that B14p's bf16 dk gate at Lq = 1 could fail on (C-11), on one
card, and the gates of ``chip_smoke.py`` over them: ``flash_cross_attention_vjp``
through ``torch.autograd.grad`` against the plain backward, and B14's
merged-head backward kernel (``flash_cross_bwd``) against its plain version
on the same tensors, at ``chip_smoke.py``'s shape (8 users x 16 heads, one
query over 1,000 keys, hd 64, its inputs from ``b14p_inputs``), over
``--seeds`` draws.

    python3 scripts/probe_b14p_lq1.py [--seeds 40]

With one query, dk's row for key j is ds_j q (scaled), so both sides' rows
should be parallel to q.  For each draw the script prints the dk row whose
cosine against the plain version is lowest, the two rows' norms beside the
largest row's, and each row's cosine with q (a row that is not parallel to
q on either side is rounding noise of a near-zero ds_j, not a kernel
fault), then holds B14p's dq / dk / dv and B14's dq / dk / dv to
``chip_smoke.kernel_error`` with its noise floor for dq and dk
(``GRAD_NOISE_FLOOR``).  Last, a summary: draws whose gates all pass, the
rows that left the cosine test and how many of them would have failed it,
the smallest ratio to the top row of a row that stayed in it, and the
largest of a row whose cosine is below the gate's.  Exits 1 if a gate
failed.  Needs a card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", type=int, default=40)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("probe_b14p_lq1: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    from unirec_tpu_torch.ops import attention as pa
    from unirec_tpu_torch.ops import flash_vjp as fl

    torch.backends.cuda.matmul.allow_tf32 = False
    b, h, lq, lkv, hd = cs.USER_RAGGED[0], cs.USER_HEADS, 1, cs.USER_RAGGED[1], 64
    floor = cs.GRAD_NOISE_FLOOR
    passed, quiet_rows, quiet_max, kept_min = 0, 0, 0.0, 1.0
    quiet_fail, fail_max = 0, 0.0
    for seed in range(args.seeds):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        q, k, v, do, bias = cs.b14p_inputs(gen, b, h, lq, lkv, hd,
                                           torch.bfloat16)
        bias32 = pa.key_bias(bias, b, lkv, q.device)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fl.flash_cross_attention_vjp(*leaves, bias)
        grads = torch.autograd.grad(out, leaves, do)
        o32, m, l = fl.flash_cross_vjp_fwd_plain(q, k, v, bias32)
        dsum = (do.float() * o32).sum(-1).transpose(1, 2).contiguous()
        ref = fl.flash_cross_vjp_bwd_plain(q, k, v, bias32, do, m, l, dsum)
        a, r = grads[1].float().reshape(-1, hd), ref[1].float().reshape(-1, hd)
        cos = torch.nn.functional.cosine_similarity(a, r, dim=-1)
        cos[r.abs().amax(-1) == 0] = 1.0
        i = int(cos.argmin())
        qrow = q.float().reshape(b * h, hd)[i // lkv]
        ck, cr = (torch.nn.functional.cosine_similarity(t[i], qrow, dim=0)
                  .item() for t in (a, r))
        print(f"seed {seed}: min dk row cosine {cos[i].item():.4f} (row {i}); "
              f"|kernel row| {a[i].norm().item():.3e}, |plain row| "
              f"{r[i].norm().item():.3e}, largest plain row "
              f"{r.norm(dim=-1).max().item():.3e}; cosine with q: kernel "
              f"{ck:.4f}, plain {cr:.4f}", flush=True)
        # B14 (merged heads) on the same tensors
        merged = [t.transpose(1, 2).reshape(b, t.shape[2], h * hd).contiguous()
                  for t in (q, k, v, do)]
        o3, m3, l3 = fl.flash_cross_fwd(*merged[:3], bias32, h)
        dsum3 = fl.attention_dsum(merged[3], o3, h).contiguous()
        args3 = (*merged[:3], bias32, merged[3], m3, l3, dsum3, h)
        # (name, kernel, plain, noise floor): dq and dk take the floor
        checks = [(f"B14P d{n} (autograd)", g, rr, floor * (n != "v"))
                  for n, g, rr in zip("qkv", grads, ref)]
        checks += [(f"B14_BWD {n}", g, rr, floor * (n != "dv3"))
                   for n, g, rr in zip(("dq", "dk3", "dv3"),
                                       fl.flash_cross_bwd(*args3),
                                       fl.flash_cross_bwd_plain(*args3))]
        ok = True
        for name, g, rr, nf in checks:
            try:
                cs.kernel_error(name, g, rr, f"seed {seed}", noise_floor=nf)
            except AssertionError as e:
                ok = False
                print(f"  FAILED: {e}", flush=True)
            if nf:
                rows = rr.float().reshape(-1, hd)
                norms = rows.norm(dim=-1)
                ratio = norms / norms.max()
                nonzero = rows.abs().amax(-1) > 0
                quiet = nonzero & (ratio < nf)
                low = nonzero & (torch.nn.functional.cosine_similarity(
                    g.float().reshape(-1, hd), rows, dim=-1) < cs.KERNEL_COS)
                quiet_rows += int(quiet.sum())
                quiet_fail += int((quiet & low).sum())
                if bool(quiet.any()):
                    quiet_max = max(quiet_max, ratio[quiet].max().item())
                if bool(low.any()):
                    fail_max = max(fail_max, ratio[low].max().item())
                kept_min = min(kept_min, ratio[nonzero & ~quiet].min().item())
        passed += ok
    print(f"{passed} of {args.seeds} draws pass every gate (B14p and B14 "
          f"backward, bf16, Lq = 1); {quiet_rows} dq / dk rows left the "
          f"cosine test below {floor:g} of the top row's norm (largest "
          f"{quiet_max:.2e}), {quiet_fail} of which have a cosine below "
          f"{cs.KERNEL_COS}; the smallest row kept: {kept_min:.2e} of the "
          f"top; the largest row below the cosine gate: {fail_max:.2e} of "
          "the top", flush=True)
    return 0 if passed == args.seeds else 1


if __name__ == "__main__":
    sys.exit(main())
