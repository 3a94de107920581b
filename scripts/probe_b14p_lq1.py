"""The rows that B14p's bf16 dk gate at Lq = 1 can fail on (C-11), on one
card: ``flash_cross_attention_vjp`` through ``torch.autograd.grad`` against
the plain backward, at ``chip_smoke.py``'s shape (8 users x 16 heads, one
query over 1,000 keys, hd 64, its inputs from ``b14p_inputs``), over
``--seeds`` draws.

    python3 scripts/probe_b14p_lq1.py [--seeds 40]

With one query, dk's row for key j is ds_j q (scaled), so both sides' rows
should be parallel to q.  For each draw the script prints the row whose
cosine against the plain version is lowest, the two rows' norms beside the
largest row's, and each row's cosine with q: a row that is not parallel to
q on either side is rounding noise of a near-zero ds_j, not a kernel fault.
Needs a card.
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
    for seed in range(args.seeds):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        q, k, v, do, bias = cs.b14p_inputs(gen, b, h, lq, lkv, hd,
                                           torch.bfloat16)
        bias32 = pa.key_bias(bias, b, lkv, q.device)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fl.flash_cross_attention_vjp(*leaves, bias)
        dk = torch.autograd.grad(out, leaves, do)[1]
        o32, m, l = fl.flash_cross_vjp_fwd_plain(q, k, v, bias32)
        dsum = (do.float() * o32).sum(-1).transpose(1, 2).contiguous()
        ref = fl.flash_cross_vjp_bwd_plain(q, k, v, bias32, do, m, l, dsum)[1]
        a, r = dk.float().reshape(-1, hd), ref.float().reshape(-1, hd)
        cos = torch.nn.functional.cosine_similarity(a, r, dim=-1)
        cos[r.abs().amax(-1) == 0] = 1.0
        i = int(cos.argmin())
        qrow = q.float().reshape(b * h, hd)[i // lkv]
        ck, cr = (torch.nn.functional.cosine_similarity(t[i], qrow, dim=0)
                  .item() for t in (a, r))
        print(f"seed {seed}: min row cosine {cos[i].item():.4f} (row {i}); "
              f"|kernel row| {a[i].norm().item():.3e}, |plain row| "
              f"{r[i].norm().item():.3e}, largest plain row "
              f"{r.norm(dim=-1).max().item():.3e}; cosine with q: kernel "
              f"{ck:.4f}, plain {cr:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
