"""Device time of each launch inside the Item Q-Former's blocks on one
card: B12s / B12c forward and backward at the item-training shape (512
items, K 32, F 14, hidden 1024, 16 heads), B1 / B2 / B3 and the W8A8
blocks B4 / B5 / B6 at the sweep's batch (4096 items), and B15 (packed item attention)
at the sweep's two shapes (4096 items, 16 heads of 64, K 32, F 32 and 14);
bf16, random unit-scale inputs from a seed (``chip_smoke.py``'s own).

    python3 scripts/profile_item_blocks.py [--iters 20] [--only B1,B3]

Each block's C entry makes several launches (GEMMs, the attention kernel,
LayerNorm).  The script prints each block's time a call from CUDA events and
then the device time of each launch inside it, with ``chip_smoke.py``'s own
``time_ms`` and ``log_split`` (``torch.profiler`` over ``--iters`` calls), so
that it measures what ``chip_smoke.py`` logs, alone and at ``--iters``.
Needs a card; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

D, HEADS, K, F = 1024, 16, 32, 14


def rand(gen, *shape, std=1.0, dtype=torch.bfloat16):
    return (torch.randn(*shape, device="cuda", generator=gen) * std).to(dtype)


def inputs(gen, items):
    mask = (torch.rand(items, F, device="cuda", generator=gen) > 0.15).float()
    mask[:: max(items // 8, 1)][:8] = 0.0
    x = rand(gen, items, K, D)
    mem = rand(gen, items, F, D) * mask[..., None].bfloat16()
    key_bias = ((1.0 - mask) * -1e9).contiguous()

    def vec(n, mean=0.0):
        return mean + rand(gen, n, std=0.1, dtype=torch.float32)

    sw = dict(wqkv=rand(gen, 3 * D, D, std=0.03), bqkv=vec(3 * D),
              wo=rand(gen, D, D, std=0.03), bo=vec(D), ln_gamma=vec(D, 1.0),
              ln_beta=vec(D))
    cw = dict(wq=rand(gen, D, D, std=0.03), bq=vec(D),
              wkv=rand(gen, 2 * D, D, std=0.03), bkv=vec(2 * D),
              wo=rand(gen, D, D, std=0.03), bo=vec(D), ln_gamma=vec(D, 1.0),
              ln_beta=vec(D))
    return x, mem, key_bias, sw, cw


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--only", default="",
                        help="comma-separated name prefixes (e.g. B6,B15)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_item_blocks: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import (QF_F, QF_HEADS, QF_K, SWEEP_BATCH, b15_inputs,
                            block_inputs, log_split, quantized, time_ms)
    from unirec_tpu_torch.ops import fused_qformer_int8 as pq
    from unirec_tpu_torch.ops import fused_qformer_layer as fq
    from unirec_tpu_torch.ops import fused_qformer_vjp as fv
    from unirec_tpu_torch.ops import packed_attention as pp
    from unirec_tpu_torch.ops._build import load_kernels

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    load_kernels()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x, mem, key_bias, sw, cw = inputs(gen, 512)
    x2, mem2 = x.reshape(-1, D), mem.reshape(-1, D)
    kb = key_bias.reshape(-1).contiguous()
    zero = torch.zeros(x2.shape[0], device="cuda")
    dout = rand(gen, *x2.shape, std=0.1)
    skw = dict(num_heads=HEADS, n_q=K)
    ckw = dict(skw, n_kv=F)
    sa = (x2, zero, sw["wqkv"], sw["bqkv"].bfloat16(), sw["wo"], sw["bo"].bfloat16())
    ca = (x2, mem2, kb, cw["wq"], cw["bq"].bfloat16(), cw["wkv"],
          cw["bkv"].bfloat16(), cw["wo"], cw["bo"].bfloat16())
    qkv = fv.self_attention_fwd(*sa, **skw)[1]
    _, q, kv, _ = fv.cross_attention_fwd(*ca, **ckw)
    runs = {
        "B12s fwd (512 items)": lambda: fv.self_attention_fwd(*sa, **skw),
        "B12s bwd (512 items)": lambda: fv.self_attention_bwd(qkv, sw["wo"], zero, dout, **skw),
        "B12c fwd (512 items)": lambda: fv.cross_attention_fwd(*ca, **ckw),
        "B12c bwd (512 items)": lambda: fv.cross_attention_bwd(q, kv, cw["wo"], kb, dout, **ckw),
    }
    xb, memb, kbb, swb, cwb = inputs(gen, 4096)
    runs["B1 (4096 items)"] = lambda: fq.fused_self_attention_block(
        xb, **swb, num_heads=HEADS, n_q=K)
    runs["B2 (4096 items)"] = lambda: fq.fused_cross_attention_block(
        xb, memb, kbb, **cwb, num_heads=HEADS, n_q=K, n_kv=F)
    xq, memq, kbq, _, swq, cwq, fw = block_inputs(gen, SWEEP_BATCH)
    runs["B3 (4096 items)"] = lambda: fq.fused_ffn_block(xq, **fw)
    swq, cwq, fwq = quantized(swq), quantized(cwq), quantized(fw)
    runs["B4 (4096 items)"] = lambda: pq.fused_self_attention_block_q(
        xq, **swq, num_heads=HEADS, n_q=K)
    runs["B5 (4096 items)"] = lambda: pq.fused_cross_attention_block_q(
        xq, memq, kbq, **cwq, num_heads=HEADS, n_q=K, n_kv=F)
    runs["B6 (4096 items)"] = lambda: pq.fused_ffn_block_q(xq, **fwq)
    for n_kv in (QF_K, QF_F):
        b15_args = b15_inputs(gen, SWEEP_BATCH, QF_K, n_kv, 64,
                              torch.bfloat16)[:4]
        runs[f"B15 (4096 items x {QF_HEADS} heads, F={n_kv})"] = (
            lambda a=b15_args: pp.packed_item_attention(*a))
    only = [p for p in args.only.split(",") if p]
    for name, fn in runs.items():
        if only and not any(name.startswith(p + " ") for p in only):
            continue
        ms = time_ms(fn, iters=args.iters)
        print(f"{name}: {ms:.4f} ms a call (CUDA events)", flush=True)
        log_split(name, fn, iters=args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
