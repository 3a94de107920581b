"""The item step's gate of ``chip_smoke.py`` (phase 7 (a), C-12) over draws
of its batch, on one card: from the sweep's seed-0 checkpoint at
``ItemQFormerConfig()``, batch 512, dropout 0, each draw a batch of
``chip_smoke.item_batches`` from ``numpy.random.default_rng(SEED + 2 +
draw)`` (draw 0 is the smoke's own batch), ``chip_smoke.item_step_parity``:
the plain-anchor step, the reference, then the fused-anchor step (B12s /
B12c) on the plain step's active set of the contrastive hinge
relu(margin + d(a, p) - d(a, n)).

    python3 scripts/probe_item_hinge.py [--draws 24]

For each draw the script prints the gate's reading: the anchor
representation's max|d| / max|ref| and least row cosine, the largest
|fused - plain| hinge argument difference and the least slack to its
per-sample bound (2 |a_f - a_p| + |p_f - p_p| + |n_f - n_p| plus both
steps' rounding of the distances), the samples whose two arguments lie on
the two sides of 0 (fused, plain, bound), the loss and the worst leaf's
gradient cosine.  Last, a summary.  Exits 1 if a draw fails the gate.
Needs a card.
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
    failed, flips, worst = 0, 0, []
    with tempfile.TemporaryDirectory() as tmp:
        cs.write_sweep_inputs(tmp)
        cfg, sd, _ = QFormerInference.read_checkpoint(os.path.join(tmp, "ckpt"))
        cache = FieldEmbeddingCache.load(os.path.join(tmp, "cache"))
        for draw in range(args.draws):
            batch = cs.item_batches(
                cache, np.random.default_rng(cs.SEED + 2 + draw), 1)[0]
            res = cs.item_step_parity(cfg, sd, batch, counters)
            failed += not res["ok"]
            flips += len(res["gate"]["flips"])
            worst.append(res["cos"])
            print(f"draw {draw}: {cs.hinge_log(res)}; loss rel "
                  f"{res['loss_rel']:.2e}, min gradient cosine "
                  f"{res['cos']:.6f} ({res['worst']})"
                  + ("" if res["ok"] else "  FAILS"), flush=True)
    print(f"summary: {args.draws - failed} of {args.draws} draws pass the "
          f"gate; {flips} flips in all; worst leaf cosine over the draws "
          f"{min(worst):.6f}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
