"""Item Q-Former engine quality: the bf16 and the int8 (W8A8) fused engines
against the fp32 model (port of ``scripts/measure_int8_quality.py``).

Production Item Q-Former config (hidden 1024, 12 layers, K=32, F=14) with
seeded random weights (the structural error of the quantization is what
transfers), batch 512, fields normal, each field present with probability
0.8 and field 0 always.  The fp32 ``ItemQFormer`` is the oracle; the
engines (``inference/fused_qformer``: kernels B1-B3 and B4-B6 on the card)
run from bf16 weights.  Reports per-token cosine similarity and relative L2
error of each engine against the oracle; ``quality_gates.py`` holds
``cos_min >= 0.999`` for both.

    python -m unirec_tpu_torch.scripts.measure_int8_quality [--device cpu] [--tiny]
"""

from __future__ import annotations

import argparse
from typing import Dict, Tuple

import torch

from unirec_tpu_torch.configs import ItemQFormerConfig
from unirec_tpu_torch.scripts import full_fp32

BATCH = 512
# --tiny: a 3-layer engine (layers 0 and 2 cross-attend) for the CPU
TINY = ItemQFormerConfig(hidden_size=64, num_hidden_layers=3,
                         num_attention_heads=4, intermediate_size=128,
                         num_query_tokens=8, field_embedding_dim=64,
                         num_fields=6, dropout=0.0)
TINY_BATCH = 64


def token_stats(out: torch.Tensor, ref: torch.Tensor
                ) -> Tuple[float, float, float, float]:
    """(mean, min) per-token cosine and (mean, max) per-token relative L2
    error of ``out`` against ``ref``, both ``[..., D]``."""
    a = out.reshape(-1, out.shape[-1]).float()
    b = ref.reshape(-1, ref.shape[-1]).float()
    cos = (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1) + 1e-9)
    rel = (a - b).norm(dim=-1) / (b.norm(dim=-1) + 1e-9)
    return (float(cos.mean()), float(cos.min()), float(rel.mean()),
            float(rel.max()))


def make_inputs(cfg: ItemQFormerConfig, batch: int, device, seed: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fields ``[batch, F, field_dim]`` normal; masks present above 0.2 of
    a uniform draw, field 0 always."""
    gen = torch.Generator(device).manual_seed(seed)
    fields = torch.randn(batch, cfg.num_fields, cfg.field_embedding_dim,
                         generator=gen, device=device)
    mask = torch.rand(batch, cfg.num_fields, generator=gen,
                      device=device) > 0.2
    mask[:, 0] = True
    return fields, mask.float()


@torch.no_grad()
def measure(model, cfg: ItemQFormerConfig, fields: torch.Tensor,
            mask: torch.Tensor) -> Dict[str, Tuple[float, float, float, float]]:
    """``token_stats`` of the bf16 and the int8 engine against ``model``'s
    fp32 query tokens, on the model's device."""
    from unirec_tpu_torch.inference.fused_qformer import (
        fused_qformer_forward,
        prepare_fused_params,
    )

    full_fp32()
    ref = model.eval().query_outputs(fields, mask)
    out = {}
    for precision in ("bf16", "int8"):
        fused = prepare_fused_params(model, cfg, dtype=torch.bfloat16,
                                     precision=precision)
        out[precision] = token_stats(
            fused_qformer_forward(fused, cfg, fields, mask), ref)
    return out


def quality_line(precision: str, stats) -> str:
    cm, cmin, rm, rmax = stats
    return (f"QUALITY {precision}: cos_mean={cm:.6f} cos_min={cmin:.6f} "
            f"rel_l2_mean={rm:.5f} rel_l2_max={rmax:.5f}")


def main(argv=None) -> int:
    from unirec_tpu_torch.utils.device import resolve_device
    from unirec_tpu_torch.utils.weights import init_item_qformer

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    p.add_argument("--tiny", action="store_true",
                   help="a 3-layer hidden-64 engine at batch 64 (CPU)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    cfg, batch = (TINY, TINY_BATCH) if args.tiny else (ItemQFormerConfig(),
                                                       BATCH)
    model = init_item_qformer(cfg, torch.Generator(device).manual_seed(0),
                              device=device)
    fields, mask = make_inputs(cfg, batch, device, seed=1)
    for precision, stats in measure(model, cfg, fields, mask).items():
        print(quality_line(precision, stats), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
