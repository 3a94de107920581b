"""The contrastive hinge of ``chip_smoke.py``'s item step (phase 7 (a), C-12)
over draws of its batch, on one card: the fused-anchor step (B12s / B12c)
and the plain-anchor step from the sweep's seed-0 checkpoint at
``ItemQFormerConfig()``, batch 512, dropout 0, each draw a batch of
``chip_smoke.item_batches`` from ``numpy.random.default_rng(SEED + 2 +
draw)`` (draw 0 is the smoke's own batch).

    python3 scripts/probe_item_hinge.py [--draws 24]

The hinge is relu(margin + d(a, p) - d(a, n)); both steps give each
sample's argument (the step's ``hinge_arguments``).  For each draw the
script prints the largest |fused - plain| difference of the arguments over
the 512 samples (the two anchors' rounding on the hinge), its 99th
percentile, the samples whose arguments lie on the two sides of 0 (fused,
plain, difference), the smoke's first gate (loss and every leaf's gradient
cosine, fused against plain), and where samples flipped, whether
``chip_smoke.hinge_flips`` admits them and the gate on one active set.
Last, a summary: the largest difference over the draws without a flip
(the rounding scale that ``HINGE_ROUNDING`` is set from), over all draws,
and every flip.  Exits 1 if a draw fails the smoke's gate.  Needs a card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--draws", type=int, default=24)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("probe_item_hinge: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    from unirec_tpu_torch.data.cache import FieldEmbeddingCache
    from unirec_tpu_torch.inference.qformer_inference import QFormerInference

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    counters = cs.item_counters()
    quiet_gaps, all_gaps, flips, failed = [], [], [], 0
    with tempfile.TemporaryDirectory() as tmp:
        cs.write_sweep_inputs(tmp)
        cfg, sd, _ = QFormerInference.read_checkpoint(os.path.join(tmp, "ckpt"))
        cache = FieldEmbeddingCache.load(os.path.join(tmp, "cache"))
        for draw in range(args.draws):
            batch = cs.item_batches(
                cache, np.random.default_rng(cs.SEED + 2 + draw), 1)[0]
            loss_f, g_f, _, arg_f = cs.item_step(cfg, sd, batch, True,
                                                 counters)
            loss_p, g_p, _, arg_p = cs.item_step(cfg, sd, batch, False,
                                                 counters)
            gap = (arg_f - arg_p).abs()
            flipped, admitted = cs.hinge_flips(arg_f, arg_p)
            cos = cs.grad_cosines(g_f, g_p)
            worst = min(cos, key=cos.get)
            rel = abs(loss_f - loss_p) / abs(loss_p)
            first = rel <= cs.STEP_LOSS_REL and cos[worst] >= cs.STEP_GRAD_COS
            line = (f"draw {draw}: |fused - plain| argument max "
                    f"{gap.max().item():.3e}, 99th percentile "
                    f"{torch.quantile(gap, 0.99).item():.3e}; |argument| "
                    f"min {arg_p.abs().min().item():.3e}; first gate: loss "
                    f"rel {rel:.2e}, min cosine {cos[worst]:.6f} ({worst})")
            ok = first and np.isfinite(loss_f)
            all_gaps.append(gap.max().item())
            if len(flipped) == 0:
                quiet_gaps.append(gap.max().item())
            else:
                seen = [(arg_f[i].item(), arg_p[i].item(), gap[i].item())
                        for i in flipped.tolist()]
                flips += seen
                line += (f"; {len(flipped)} flipped (fused, plain, "
                         f"difference): "
                         f"{[tuple(f'{x:.3e}' for x in t) for t in seen]}, "
                         f"{'admitted' if admitted else 'not admitted'}")
                ok = admitted
                if admitted:
                    loss_p, g_p, _, _ = cs.item_step(
                        cfg, sd, batch, False, counters,
                        active=(arg_f > 0).float())
                    cos = cs.grad_cosines(g_f, g_p)
                    worst = min(cos, key=cos.get)
                    rel = abs(loss_f - loss_p) / abs(loss_p)
                    ok = (rel <= cs.STEP_LOSS_REL
                          and cos[worst] >= cs.STEP_GRAD_COS)
                    line += (f"; on one active set: loss rel {rel:.2e}, min "
                             f"cosine {cos[worst]:.6f} ({worst})")
            failed += not ok
            print(line + ("" if ok else "  FAILS"), flush=True)
            del g_f, g_p
    print(f"summary: {args.draws - failed} of {args.draws} draws pass the "
          f"smoke's gate (at most {cs.HINGE_FLIP_MAX} flips, each within "
          f"{cs.HINGE_ROUNDING:g}); {len(quiet_gaps)} draws without a flip, "
          f"largest |fused - plain| argument over them "
          f"{max(quiet_gaps, default=float('nan')):.3e}; over all draws "
          f"{max(all_gaps):.3e}; {len(flips)} flips, differences "
          f"{sorted(round(t[2], 6) for t in flips)}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
