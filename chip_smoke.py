"""Smoke run of the PyTorch port's main paths on one NVIDIA Hopper GPU: the
serving path (over a float32 and an int8 catalog, and with the W8A8 int8
Qwen3 forward) and the item-token sweep (bf16 and W8A8 int8).

    python3 chip_smoke.py

Phases (any failed check raises; the script then exits non-zero):

1. device: ``nvidia-smi`` name and power limit, torch's device name and
   compute capability.  No CUDA device of capability (9, 0) -> exit 2.
2. build: the hand-written CUDA kernels from ``unirec_tpu_torch/csrc`` (one
   nvcc per source for sm_90a, started together; ``-Xptxas -v`` printed).
3. kernels vs plain versions at the slices' shapes, timed with CUDA events:
   K1 causal GQA flash attention (B=8, L=512, 16/8 heads, hd 128, row lengths
   1..512) in fp32 and bf16; K2 blocked top-k retrieval (8 and 64 users,
   20,000 x 1,024 catalog, k=20) and B11, the same over the catalog
   quantized to int8; B1/B2/B3, the Item Q-Former's self, cross and FFN
   blocks in bf16 at production widths (hidden 1024, 16 heads, K=32, F=14,
   intermediate 4096) for 4096 and a ragged 1001 items (B1 also at the 1-item
   layer-0 shape), with ~15% missing fields and >= 8 items that have none;
   B1/B2 at K=128 and 256 (64 items); B4/B5/B6, the W8A8 blocks, as B1-B3;
   B8, the W8A8 linear, at the Qwen3-0.6B serving projections (4096 rows:
   1024->2048, 1024->1024, 2048->1024, 1024->3072, 3072->1024; and
   1024->2048 at 16384 rows), B9a (q|k|v, [4096, 1024] -> 4096) and B9b (the
   SwiGLU MLP, [4096, 1024], intermediate 3072).
4. the serving slice at full width (Qwen3-0.6B, 28 layers; 12-layer Item
   Q-Former with K=2; LoRA r=16 with nonzero lora_b; L=512; bf16; random
   weights from seed 0): 24 concurrent HTTP ``/recommend`` requests through
   ``make_server``, answers checked against direct ``recommend`` calls, both
   kernels' launch counters checked, both kernels compared with their plain
   versions on the tensors the served run fed them.  Then a second
   ``Recommender(quantize_catalog=True)`` over the same model and catalog
   answers the same histories through B11 (answers checked, B11's counter
   checked, B11 held to its plain version on the served users, top-10 overlap
   with the float32 catalog's answers printed).  Then int8 serving on the
   same shared model: (a) ``precision="int8"`` with the adapters live (B8 on
   all 7 x 28 projections per batch), (b) ``merge_lora=True`` (B9a, B9b and
   B8 on o_proj, 28 each per batch), (c) the merged model with
   ``fused_blocks=False``; each one's launches, user cosine and top-10
   overlap against bf16, latency and peak memory; (b) against (c), split by
   two controls that run (c)'s model with plain MLPs, B9b's (fp32 g, u and
   h) and the per-projection chain's (bf16); the 24-request HTTP burst
   through (b) with the answer checks above and 28 launches of each kernel
   per batch the batcher ran; B8, B9a and B9b held to their plain versions
   on what (b) fed layer 0; a ``torch.profiler`` breakdown of one (b) batch; the shared model's
   checksum unchanged.  Last, ``serve_cli.build_recommender`` with
   ``--precision int8 --merge-lora`` over files written from this stack (a
   full-width K=2 Item Q-Former checkpoint directory, a field-cache
   directory, item and catalog JSON of 2,000 items) answers one batch
   through B9a, B9b and B8.
5. the item-token sweep at full width (``ItemQFormerConfig()``, random
   weights from seed 0 saved as a checkpoint directory; a 9,000-item field
   cache from the seed): the port's ``generate_all_item_embeddings.main`` at
   batch 4096, once with ``--precision bf16`` and once with ``int8``; each
   run's output, fallback count and block launch counts checked (B1-B3 or
   B4-B6, 12/6/12 per batch, none of the other precision's), its tokens held
   to the engine on the plain block functions and to the fp32
   ``ItemQFormer``; items/s, TFLOP/s, peak memory and a ``torch.profiler``
   breakdown by kernel.
6. the ``kernels`` JSON line, then the last line ``{"ok": true, ...}``.

TF32 stays off for both matmul flags: float32 products are full precision,
so the fp32 tolerances below hold.
"""

from __future__ import annotations

import gc
import json
import os
import pickle
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SEED = 0
K1_SHAPE = dict(B=8, L=512, HQ=16, HKV=8, HD=128)
K2_USERS = (8, 64)
CATALOG, DIM, K2_K = 20_000, 1_024, 20
N_REQUESTS, SERVE_K, BATCH = 24, 10, 8
K1_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
K2_TIE, K2_SCORE_TOL = 1e-6, 1e-5
# B1-B3 (bf16 in and out) against their plain versions on the same inputs, in
# fp32: the kernels sum in another order than the plain version, which can
# flip a bf16 rounding of qkv, probabilities, ctx or the gelu output and move
# a unit-scale LayerNorm output by a few bf16 ulps
BLOCK_ATOL, BLOCK_COS = 5e-2, 0.9999
QF_D, QF_HEADS, QF_K, QF_F, QF_INTER = 1024, 16, 32, 14, 4096
BLOCK_ITEMS = (4096, 1001)
# the attention kernel's repaired limit: K up to 256 query rows per item
WIDE_K, WIDE_K_ITEMS = (128, 256), 64
SWEEP_ITEMS, SWEEP_BATCH, SWEEP_SAMPLE = 9000, 4096, 256
# the sweep's tokens against the same engine on the plain block functions:
# 30 chained blocks carry each block's one-ulp rounding flips forward, so the
# bound is four bf16 ulps at the top of the LayerNorm outputs' range
# (|y| < 8, ulp 2**-5), per-token cosine as for one block.  The int8 engine
# is held by cosine alone, at the int8 quality-gate class: requantization is
# discontinuous, so a difference far below a code step (one flipped bf16
# rounding) flips codes and grows over 30 blocks to about the engine's own
# quantization noise.  Each run prints that noise floor: the plain engine
# against itself on inputs one bf16 ulp apart (0.99933 min token cosine on
# an H100, as far as the kernel engine is from the plain one).
SWEEP_PLAIN_ATOL, SWEEP_PLAIN_COS = 0.125, 0.9999
SWEEP_PLAIN_COS_INT8 = 0.999
# either engine vs the fp32 model: the bf16 and int8 quality-gate class of
# scripts/quality_gates.py (per-token cosine)
SWEEP_FP32_COS = 0.999
# the int8 serving slice's kernels at the Qwen3-0.6B serving shapes: B8 on
# every projection of batch 8 x L 512 = 4096 rows (K -> N) and on one at
# batch 32; B9a over [Wq | Wk | Wv]; B9b over the whole MLP
QW_D, QW_QKV, QW_I = 1024, 4096, 3072
B8_SHAPES = ((4096, 1024, 2048), (4096, 1024, 1024), (4096, 2048, 1024),
             (4096, 1024, 3072), (4096, 3072, 1024), (16384, 1024, 2048))
B9_ROWS = 4096
# B9b against its plain version: the card's sigmoid is not torch's, which can
# flip a code of the requantized h
B9B_COS, B9B_REL = 0.9999, 1e-2
# int8 serving against bf16: the int8 quality class of tests/test_serving.py.
# The fused blocks (b) against the per-projection path (c) on the same merged
# weights differ by design: (c) rounds gate, up and silu(g) * u to bf16 where
# B9b keeps them fp32.  Two controls run (c)'s model with its MLPs replaced
# by plain versions: (c32) B9b's (fp32 intermediates) and (c16) the
# per-projection chain's (B8's plain version, silu(g) * u in bf16).  (b) is
# held to (c32) and (c) to (c16) at the 0.9999 class of
# tests/test_serving.py; (c32) against (c16) is that rounding alone, and (b)
# against (c) may not fall further below 1 than it by more than the margin
INT8_VS_BF16_COS, FUSED_VS_CONTROL_COS, ROUNDING_GAP_MARGIN = 0.98, 0.9999, 2e-5
ENTRY_ITEMS = 2000  # the serve_cli catalog: small JSON files


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- K1 ---------------------------------------------------------------------


def k1_error(q, k, v, mask, hq, hkv):
    """(max|kernel - ref|, max|ref|); ref = plain version in fp32 on the same
    (possibly bf16-rounded) inputs."""
    from unirec_tpu_torch.ops.flash_causal import (
        flash_causal_attention,
        flash_causal_attention_plain,
    )

    out = flash_causal_attention(q, k, v, mask, hq, hkv)
    torch.cuda.synchronize()
    ref = flash_causal_attention_plain(q.float(), k.float(), v.float(), mask,
                                       hq, hkv)
    return (out.float() - ref).abs().max().item(), ref.abs().max().item()


def check_k1(err: float, ref_max: float, dtype, where: str) -> None:
    rel = err / ref_max
    log(f"K1 {where} {dtype}: max|d| {err:.3e} max|ref| {ref_max:.3e} "
        f"rel {rel:.3e} (tol {K1_TOL[dtype]:g})")
    if not rel <= K1_TOL[dtype]:
        raise AssertionError(f"K1 {where} {dtype} disagrees: rel {rel}")


def phase_k1(gen) -> dict:
    from unirec_tpu_torch.ops.flash_causal import (
        flash_causal_attention,
        flash_causal_attention_plain,
    )

    b, l, hq, hkv, hd = (K1_SHAPE[x] for x in ("B", "L", "HQ", "HKV", "HD"))
    lengths = torch.tensor([1, 7, 64, 65, 200, 333, 511, 512], device="cuda")
    mask = (torch.arange(l, device="cuda")[None] < lengths[:, None]).float()
    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(b, l, hq * hd, device="cuda", generator=gen).to(dtype)
        k = torch.randn(b, l, hkv * hd, device="cuda", generator=gen).to(dtype)
        v = torch.randn(b, l, hkv * hd, device="cuda", generator=gen).to(dtype)
        check_k1(*k1_error(q, k, v, mask, hq, hkv), dtype, "phase 3")
        kern = time_ms(lambda: flash_causal_attention(q, k, v, mask, hq, hkv))
        plain = time_ms(
            lambda: flash_causal_attention_plain(q, k, v, mask, hq, hkv))
        kern2 = time_ms(lambda: flash_causal_attention(q, k, v, mask, hq, hkv))
        times[dtype] = (min(kern, kern2), plain)
        log(f"K1 time {dtype} B={b} L={l} Hq={hq} Hkv={hkv} hd={hd}: kernel "
            f"{kern:.4f} / {kern2:.4f} ms, plain {plain:.4f} ms")
    return times


# -- K2 ---------------------------------------------------------------------


def k2_compare(users, catalog, k):
    """Kernel vs plain retrieval; returns the max score difference."""
    from unirec_tpu_torch.ops.losses import l2_normalize
    from unirec_tpu_torch.ops.ranking import retrieve_top_k, top_k_items

    s, i = retrieve_top_k(users, catalog, k=k)
    torch.cuda.synchronize()
    s_ref, i_ref = top_k_items(users, catalog, k=k)
    full = l2_normalize(users.float()) @ l2_normalize(catalog.float()).T
    score_err = (s - s_ref).abs().max().item()
    if not score_err <= K2_SCORE_TOL:
        raise AssertionError(f"K2 scores differ by {score_err}")
    diff = i != i_ref
    if diff.any():  # only near-ties may swap: the kernel's pick must score
        picked = full.gather(1, i)  # within K2_TIE of the rank's true score
        gap = (picked - s_ref)[diff].abs().max().item()
        if not gap < K2_TIE:
            raise AssertionError(f"K2 ids differ beyond near-ties ({gap})")
    log(f"K2 users={users.shape[0]} N={catalog.shape[0]} k={k}: "
        f"max|d score| {score_err:.3e}, id mismatches {int(diff.sum())} "
        f"(near-ties only)")
    return score_err


def phase_k2(gen) -> dict:
    from unirec_tpu_torch.ops.losses import l2_normalize
    from unirec_tpu_torch.ops.ranking import retrieve_top_k, top_k_items

    catalog = torch.randn(CATALOG, DIM, device="cuda", generator=gen)
    cat_n = l2_normalize(catalog)
    times = {}
    for n_users in K2_USERS:
        users = torch.randn(n_users, DIM, device="cuda", generator=gen)
        k2_compare(users, catalog, K2_K)
        u_n = l2_normalize(users)
        kern = time_ms(lambda: retrieve_top_k(users, catalog, k=K2_K))
        plain = time_ms(lambda: top_k_items(users, catalog, k=K2_K))
        bare = time_ms(lambda: retrieve_top_k(u_n, cat_n, k=K2_K,
                                              normalize=False))
        bare_plain = time_ms(lambda: top_k_items(u_n, cat_n, k=K2_K,
                                                 normalize=False))
        kern2 = time_ms(lambda: retrieve_top_k(users, catalog, k=K2_K))
        times[n_users] = (min(kern, kern2), plain)
        log(f"K2 time users={n_users}: with normalisation kernel {kern:.4f} / "
            f"{kern2:.4f} ms, plain {plain:.4f} ms; pre-normalised kernel "
            f"{bare:.4f} ms, plain {bare_plain:.4f} ms")
    return times


# -- B1-B3 ------------------------------------------------------------------


def block_error(out, ref):
    """(max|kernel - plain|, min per-row cosine), in fp32."""
    a = out.float().reshape(-1, out.shape[-1])
    b = ref.float().reshape(-1, ref.shape[-1])
    if not bool(torch.isfinite(a).all()):
        raise AssertionError("a block kernel returned non-finite values")
    cos = torch.nn.functional.cosine_similarity(a, b, dim=-1).min().item()
    return (a - b).abs().max().item(), cos


def check_block(name, err, cos, where):
    log(f"{name} {where}: max|d| {err:.3e} (tol {BLOCK_ATOL:g}), min row "
        f"cosine {cos:.7f} (tol {BLOCK_COS})")
    if not (err <= BLOCK_ATOL and cos >= BLOCK_COS):
        raise AssertionError(f"{name} {where} disagrees with its plain version")


def block_inputs(gen, items):
    """Unit-scale bf16 activations, ~15% missing fields, >= 8 items with no
    field at all, and random weights of the blocks' layouts."""
    def rand(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, device="cuda", generator=gen) * std
                ).to(dtype)

    def vec(n, mean=0.0):
        return mean + rand(n, std=0.1, dtype=torch.float32)

    d, k, f, inter = QF_D, QF_K, QF_F, QF_INTER
    x = rand(items, k, d)
    mask = (torch.rand(items, f, device="cuda", generator=gen) > 0.15).float()
    mask[:: max(items // 8, 1)][:8] = 0.0
    mem = rand(items, f, d) * mask[..., None].bfloat16()
    key_bias = ((1.0 - mask) * -1e9).contiguous()
    self_w = dict(wqkv=rand(3 * d, d, std=0.03), bqkv=vec(3 * d),
                  wo=rand(d, d, std=0.03), bo=vec(d), ln_gamma=vec(d, 1.0),
                  ln_beta=vec(d))
    cross_w = dict(wq=rand(d, d, std=0.03), bq=vec(d),
                   wkv=rand(2 * d, d, std=0.03), bkv=vec(2 * d),
                   wo=rand(d, d, std=0.03), bo=vec(d), ln_gamma=vec(d, 1.0),
                   ln_beta=vec(d))
    ffn_w = dict(w1=rand(inter, d, std=0.03), b1=vec(inter),
                 w2=rand(d, inter, std=0.02), b2=vec(d), ln_gamma=vec(d, 1.0),
                 ln_beta=vec(d))
    return x, mem, key_bias, mask, self_w, cross_w, ffn_w


# the int8 blocks take each weight as int8 codes beside its column scales
SCALE_OF = {"wqkv": "sqkv", "wo": "so", "wq": "sq", "wkv": "skv", "w1": "s1",
            "w2": "s2"}


def quantized(weights: dict) -> dict:
    from unirec_tpu_torch.ops.fused_qformer_int8 import quantize_weight

    out = dict(weights)
    for name, scale in SCALE_OF.items():
        if name in weights:
            out[name], out[scale] = quantize_weight(weights[name])
    return out


def phase_blocks(gen, precision: str) -> dict:
    """B1-B3 (bf16) or B4-B6 (int8) against their plain versions."""
    from unirec_tpu_torch.ops import fused_qformer_int8 as pq
    from unirec_tpu_torch.ops import fused_qformer_layer as fq

    mod, sfx, names = ((fq, "", ("b1", "b2", "b3")) if precision == "bf16"
                       else (pq, "_q", ("b4", "b5", "b6")))
    self_k, cross_k, ffn_k = (
        (getattr(mod, f + sfx), getattr(mod, f + sfx + "_plain"))
        for f in ("fused_self_attention_block", "fused_cross_attention_block",
                  "fused_ffn_block"))
    sn, cn, fn_ = names
    sk = dict(num_heads=QF_HEADS, n_q=QF_K)
    ck = dict(num_heads=QF_HEADS, n_q=QF_K, n_kv=QF_F)
    result = {name: {"err": 0.0} for name in names}
    for items in BLOCK_ITEMS:
        x, mem, key_bias, mask, sw, cw, fw = block_inputs(gen, items)
        if precision == "int8":
            sw, cw, fw = quantized(sw), quantized(cw), quantized(fw)
        runs = {
            sn: (lambda: self_k[0](x, **sw, **sk),
                 lambda: self_k[1](x, **sw, **sk)),
            cn: (lambda: cross_k[0](x, mem, key_bias, **cw, **ck),
                 lambda: cross_k[1](x, mem, key_bias, **cw, **ck)),
            fn_: (lambda: ffn_k[0](x, **fw), lambda: ffn_k[1](x, **fw)),
        }
        shapes = [(items, sn, runs[sn])]
        if items == BLOCK_ITEMS[0]:  # layer 0's self block: one item
            x1 = x[:1].contiguous()
            shapes.append((1, sn, (lambda: self_k[0](x1, **sw, **sk),
                                   lambda: self_k[1](x1, **sw, **sk))))
        shapes += [(items, cn, runs[cn]), (items, fn_, runs[fn_])]
        for n, name, (kern, plain) in shapes:
            out = kern()
            torch.cuda.synchronize()
            err, cos = block_error(out, plain())
            check_block(name.upper(), err, cos, f"{n} items")
            result[name]["err"] = max(result[name]["err"], err)
        # an item with no field does not depend on the rest of its batch
        empty = int(torch.nonzero(mask.sum(1) == 0)[0])
        alone = cross_k[0](
            x[empty:empty + 1].contiguous(), mem[empty:empty + 1].contiguous(),
            key_bias[empty:empty + 1].contiguous(), **cw, **ck)
        full = runs[cn][0]()
        if not torch.equal(alone[0], full[empty]):
            raise AssertionError(f"{cn.upper()}: an all-missing item depends "
                                 "on its batch")
        log(f"{cn.upper()} {items} items: {int((mask.sum(1) == 0).sum())} "
            f"items without fields, {float((mask == 0).float().mean()):.3f} of "
            f"fields missing; the all-missing item {empty} alone equals its "
            "batch row")
        if items == BLOCK_ITEMS[0]:
            for name in names:
                kern, plain = runs[name]
                t_k = time_ms(kern, iters=10, warmup=2)
                t_p = time_ms(plain, iters=5, warmup=1)
                t_k2 = time_ms(kern, iters=10, warmup=2)
                result[name].update(ms=min(t_k, t_k2), plain_ms=t_p)
                log(f"{name.upper()} time {items} items: kernel {t_k:.4f} / "
                    f"{t_k2:.4f} ms, plain {t_p:.4f} ms")
        del x, mem, key_bias, runs, shapes
        torch.cuda.empty_cache()
    return result


def phase_wide_k(gen) -> dict:
    """B1 and B2 at K=128 and 256 query rows per item (64 items): the
    attention kernel tiles the queries and keeps keys and values in bf16."""
    from unirec_tpu_torch.ops import fused_qformer_layer as fq

    errs = {"b1": 0.0, "b2": 0.0}
    _, _, _, _, sw, cw, _ = block_inputs(gen, 1)
    for n_q in WIDE_K:
        items = WIDE_K_ITEMS
        x = (torch.randn(items, n_q, QF_D, device="cuda", generator=gen)
             ).bfloat16()
        mask = (torch.rand(items, QF_F, device="cuda", generator=gen) > 0.15
                ).float()
        mask[::8] = 0.0
        mem = (torch.randn(items, QF_F, QF_D, device="cuda", generator=gen)
               * mask[..., None]).bfloat16()
        key_bias = ((1.0 - mask) * -1e9).contiguous()
        sk = dict(num_heads=QF_HEADS, n_q=n_q)
        ck = dict(sk, n_kv=QF_F)
        for name, kern, plain in (
                ("b1", lambda: fq.fused_self_attention_block(x, **sw, **sk),
                 lambda: fq.fused_self_attention_block_plain(x, **sw, **sk)),
                ("b2", lambda: fq.fused_cross_attention_block(
                    x, mem, key_bias, **cw, **ck),
                 lambda: fq.fused_cross_attention_block_plain(
                     x, mem, key_bias, **cw, **ck))):
            out = kern()
            torch.cuda.synchronize()
            err, cos = block_error(out, plain())
            check_block(name.upper(), err, cos, f"K={n_q}, {items} items")
            errs[name] = max(errs[name], err)
    return errs


def b11_compare(users, codes, scales, k):
    """B11 vs its plain version; returns the max score difference."""
    from unirec_tpu_torch.ops.quantization import (
        quantized_scores,
        quantized_top_k,
        retrieve_top_k_int8,
    )

    s, i = retrieve_top_k_int8(users, codes, scales, k=k)
    torch.cuda.synchronize()
    s_ref, i_ref = quantized_top_k(users, codes, scales, k=k)
    score_err = (s - s_ref).abs().max().item()
    if not score_err <= K2_SCORE_TOL:
        raise AssertionError(f"B11 scores differ by {score_err}")
    diff = i != i_ref
    if diff.any():  # only near-ties may swap
        picked = quantized_scores(users, codes, scales).gather(1, i)
        gap = (picked - s_ref)[diff].abs().max().item()
        if not gap < K2_TIE:
            raise AssertionError(f"B11 ids differ beyond near-ties ({gap})")
    log(f"B11 users={users.shape[0]} N={codes.shape[0]} k={k}: "
        f"max|d score| {score_err:.3e}, id mismatches {int(diff.sum())} "
        f"(near-ties only)")
    return score_err


def phase_b11(gen) -> dict:
    from unirec_tpu_torch.ops.quantization import (
        quantize_rows,
        quantized_top_k,
        retrieve_top_k_int8,
    )

    codes, scales = quantize_rows(
        torch.randn(CATALOG, DIM, device="cuda", generator=gen))
    times = {}
    for n_users in K2_USERS:
        users = torch.randn(n_users, DIM, device="cuda", generator=gen)
        b11_compare(users, codes, scales, K2_K)
        kern = time_ms(lambda: retrieve_top_k_int8(users, codes, scales,
                                                   k=K2_K))
        plain = time_ms(lambda: quantized_top_k(users, codes, scales, k=K2_K))
        kern2 = time_ms(lambda: retrieve_top_k_int8(users, codes, scales,
                                                    k=K2_K))
        times[n_users] = (min(kern, kern2), plain)
        log(f"B11 time users={n_users} (int8 catalog {CATALOG} x {DIM}, "
            f"{codes.numel() / 1e6:.1f} MB): kernel {kern:.4f} / "
            f"{kern2:.4f} ms, plain {plain:.4f} ms")
    return times


# -- B8, B9a, B9b -------------------------------------------------------------


def ulp_error(out, ref) -> float:
    """max |out - ref| in bf16 ulps of ref (0 when equal)."""
    a, b = out.float(), ref.float()
    if not bool(torch.isfinite(a).all()):
        raise AssertionError("an int8 kernel returned non-finite values")
    ulp = torch.exp2(torch.floor(torch.log2(b.abs().clamp_min(1e-30))) - 7)
    return ((a - b).abs() / ulp).max().item()


def check_int8_linear(name, out, ref, where) -> float:
    """B8 / B9a: equal to the plain version, or within one bf16 ulp."""
    ulps = ulp_error(out, ref)
    err = (out.float() - ref.float()).abs().max().item()
    log(f"{name} {where}: max|d| {err:.3e}, {ulps:.2f} bf16 ulps (tol 1), "
        f"{int((out != ref).sum())} of {out.numel()} values differ")
    if not ulps <= 1.0:
        raise AssertionError(f"{name} {where} disagrees with its plain version")
    return err


def check_swiglu(out, ref, where) -> float:
    a, b = out.float(), ref.float()
    if not bool(torch.isfinite(a).all()):
        raise AssertionError("B9B returned non-finite values")
    err = (a - b).abs().max().item()
    rel = err / b.abs().max().item()
    cos = torch.nn.functional.cosine_similarity(a, b, dim=-1).min().item()
    log(f"B9B {where}: max|d| {err:.3e} = {rel:.2e} of max|ref| (tol "
        f"{B9B_REL:g}), min row cosine {cos:.7f} (tol {B9B_COS})")
    if not (rel <= B9B_REL and cos >= B9B_COS):
        raise AssertionError(f"B9B {where} disagrees with its plain version")
    return err


def phase_qwen3_int8(gen) -> dict:
    """B8, B9a and B9b against their plain versions at the serving shapes,
    with bf16-rounded random weights quantized per output column."""
    from unirec_tpu_torch.ops import fused_qwen3_int8 as pf
    from unirec_tpu_torch.ops.fused_qformer_int8 import quantize_weight
    from unirec_tpu_torch.ops.int8_matmul import int8_linear, int8_linear_plain

    def rand(*shape, std=1.0):
        return (torch.randn(*shape, device="cuda", generator=gen) * std
                ).bfloat16()

    def timed(name, kern, plain):
        t_k = time_ms(kern, iters=20)
        t_p = time_ms(plain, iters=5, warmup=1)
        t_k2 = time_ms(kern, iters=20)
        log(f"{name} time: kernel {t_k:.4f} / {t_k2:.4f} ms, plain "
            f"{t_p:.4f} ms")
        return min(t_k, t_k2), t_p

    out = {"b8": {"err": 0.0}}
    for rows, k, n in B8_SHAPES:
        x = rand(rows, k)
        x[5] = 0.0  # a row below the absmax floor
        wq, ws = quantize_weight(rand(n, k, std=0.03))
        where = f"[{rows}, {k}] -> {n}"
        err = check_int8_linear("B8", int8_linear(x, wq, ws),
                                int8_linear_plain(x, wq, ws), where)
        out["b8"]["err"] = max(out["b8"]["err"], err)
        ms, plain_ms = timed(f"B8 {where}", lambda: int8_linear(x, wq, ws),
                             lambda: int8_linear_plain(x, wq, ws))
        out["b8"][(rows, k, n)] = (ms, plain_ms)
        if (rows, k, n) == B8_SHAPES[0]:
            out["b8"].update(ms=ms, plain_ms=plain_ms)
    x = rand(B9_ROWS, QW_D)
    wqkv, sqkv = quantize_weight(rand(QW_QKV, QW_D, std=0.03))
    where = f"[{B9_ROWS}, {QW_D}] -> {QW_QKV}"
    err = check_int8_linear("B9A", pf.qkv_int8(x, wqkv, sqkv),
                            pf.qkv_int8_plain(x, wqkv, sqkv), where)
    ms, plain_ms = timed(f"B9A {where}", lambda: pf.qkv_int8(x, wqkv, sqkv),
                         lambda: pf.qkv_int8_plain(x, wqkv, sqkv))
    out["b9a"] = dict(err=err, ms=ms, plain_ms=plain_ms)
    wgu, sgu = quantize_weight(rand(2 * QW_I, QW_D, std=0.03))
    wd, sd = quantize_weight(rand(QW_D, QW_I, std=0.02))
    args = (x, wgu, sgu, wd, sd)
    where = f"[{B9_ROWS}, {QW_D}], I {QW_I}"
    err = check_swiglu(pf.swiglu_mlp_int8(*args),
                       pf.swiglu_mlp_int8_plain(*args), where)
    ms, plain_ms = timed(f"B9B {where}", lambda: pf.swiglu_mlp_int8(*args),
                         lambda: pf.swiglu_mlp_int8_plain(*args))
    out["b9b"] = dict(err=err, ms=ms, plain_ms=plain_ms)
    return out


# -- phase 4: the serving slice ----------------------------------------------


def build_stack():
    from unirec_tpu.configs import (
        ItemQFormerConfig,
        JointModelConfig,
        LoRAConfig,
        Qwen3Config,
    )
    from unirec_tpu.data.cache import FieldEmbeddingCache
    from unirec_tpu_torch.data.tokenizer import HashTokenizer
    from unirec_tpu_torch.serving.recommender import Recommender
    from unirec_tpu_torch.utils.weights import init_joint

    qwen, qf = Qwen3Config(), ItemQFormerConfig(num_query_tokens=2)
    jc = JointModelConfig(max_length=512)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    model = init_joint(qwen, qf, jc, LoRAConfig(), gen, device="cuda",
                       dtype=torch.bfloat16, lora_b_std=0.02)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model: Qwen3 {qwen.num_hidden_layers} layers x {qwen.hidden_size}, "
        f"vocab {qwen.vocab_size}+{model.num_special_tokens}; Item Q-Former "
        f"{qf.num_hidden_layers} layers K={qf.num_query_tokens} "
        f"F={qf.num_fields}; LoRA r=16 nonzero lora_b; {n_params} parameters "
        f"bf16; built in {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    item_ids = [f"item{j}" for j in range(CATALOG)]
    emb = rng.standard_normal((CATALOG, qf.num_fields, qf.field_embedding_dim),
                              dtype=np.float32)
    masks = (rng.random((CATALOG, qf.num_fields)) > 0.15).astype(np.float32)
    masks[:, 0] = 1.0
    emb *= masks[..., None]  # a missing field has a zero embedding
    cache = FieldEmbeddingCache(emb, masks, [f"f{i}" for i in range(14)],
                                item_ids)
    cat = rng.standard_normal((CATALOG, DIM), dtype=np.float32)
    catalog = dict(zip(item_ids, cat))
    words = ["serum", "lip", "balm", "cherry", "matte", "gloss", "travel",
             "size", "vitamin", "mask", "oil", "brush", "set", "mini", "rose"]
    item_dict = {
        iid: {"title": " ".join(rng.choice(words, rng.integers(3, 12)))}
        for iid in item_ids
    }
    tok = HashTokenizer(qwen.vocab_size, jc.num_history_items,
                        jc.num_query_tokens_per_item)
    rec = Recommender(model, tok, item_dict, cache, catalog, batch_size=BATCH)
    log(f"data: field cache {CATALOG} x {qf.num_fields} x "
        f"{qf.field_embedding_dim} on device as bf16 "
        f"({rec._cache_emb_dev.numel() * 2 / 1e9:.3f} GB), "
        f"{int((masks == 0).sum())} missing fields; catalog {CATALOG} x {DIM}; "
        f"made in {time.perf_counter() - t0:.1f} s")
    return rec, item_ids, rng


def post(url: str, payload: dict):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=300) as resp:
        return resp.status, json.loads(resp.read())


def phase_serve(smi: str) -> dict:
    from unirec_tpu_torch.ops.flash_causal import flash_causal_attention
    from unirec_tpu_torch.ops.losses import l2_normalize
    from unirec_tpu_torch.ops.ranking import retrieve_top_k
    from unirec_tpu_torch.serving.server import make_server

    rec, item_ids, rng = build_stack()
    histories = [
        [str(x) for x in rng.choice(item_ids, n, replace=False)]
        for n in (np.arange(N_REQUESTS) % 13)  # history lengths 0..12
    ]
    torch.cuda.reset_peak_memory_stats()
    # admit the whole burst: the default admission bound (two batches) would
    # shed a third of it with 503s
    server, batcher = make_server(rec, port=0, warmup=True,
                                  max_queued=N_REQUESTS)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    # capture what the served run feeds the kernels: layer 0's attention
    # inputs and the batch's pooled user embeddings (last batch wins)
    seen = {}
    attn0 = rec.model.base_model.layers[0].self_attn
    hooks = [
        attn0.register_forward_pre_hook(
            lambda mod, args: seen.__setitem__("attn0", args)),
        rec.model.register_forward_hook(
            lambda mod, args, out: seen.__setitem__("pooled", out)),
    ]
    try:
        flash_causal_attention.launches = 0
        retrieve_top_k.launches = 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=N_REQUESTS) as pool:
            answers = list(pool.map(
                lambda h: post(f"{base}/recommend", {"history": h,
                                                     "k": SERVE_K}),
                histories))
        burst_s = time.perf_counter() - t0
        launches = {"k1": flash_causal_attention.launches,
                    "k2": retrieve_top_k.launches}
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
    finally:
        for h in hooks:
            h.remove()
        server.shutdown()
        server.server_close()
        batcher.close()
        thread.join(timeout=30)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"served {N_REQUESTS} requests in {burst_s:.3f} s over HTTP "
        f"({health['batches_run']} batches, warmup included); launches "
        f"during the requests: K1 {launches['k1']}, K2 {launches['k2']}")
    if not (launches["k1"] > 0 and launches["k2"] > 0):
        raise AssertionError(f"a kernel was not launched: {launches}")

    direct = rec.recommend(histories, k=SERVE_K)
    for h, (status, out), want in zip(histories, answers, direct):
        items = out.get("items", [])
        ids = [r["item_id"] for r in items]
        scores = [r["score"] for r in items]
        if status != 200 or len(items) != SERVE_K:
            raise AssertionError(f"bad answer {status} {out}")
        if set(ids) & set(h):
            raise AssertionError("a history item was recommended")
        if scores != sorted(scores, reverse=True) or not all(
                -1.0 <= s <= 1.0 for s in scores):
            raise AssertionError(f"bad scores {scores}")
        if ids != [r.item_id for r in want]:
            raise AssertionError(f"HTTP answer differs from recommend(): "
                                 f"{ids} vs {[r.item_id for r in want]}")
        if not np.allclose(scores, [r.score for r in want], atol=1e-5, rtol=0):
            raise AssertionError("HTTP scores differ from recommend()")
    log(f"{N_REQUESTS}/{N_REQUESTS} HTTP answers valid: 200, {SERVE_K} items, "
        f"no history items, scores descending in [-1, 1], equal to direct "
        f"recommend(); healthz ok={health['ok']}")

    # K1 and K2 on the tensors the served run fed them
    c = rec.model.qwen_config
    with torch.no_grad():
        hidden, cos, sin, pad_mask = seen["attn0"]
        q, k, v = attn0.qkv(hidden, cos, sin)
        err, ref_max = k1_error(q, k, v, pad_mask, c.num_attention_heads,
                                c.num_key_value_heads)
        check_k1(err, ref_max, q.dtype, "served layer 0")
        users = l2_normalize(seen["pooled"]).float()
        k2_err = k2_compare(users, rec._catalog_dev,
                            SERVE_K + rec.jc.num_history_items)

    lat = []
    batch = histories[:BATCH]
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec.recommend(batch, k=SERVE_K)  # ends in a device-to-host copy
        lat.append(time.perf_counter() - t0)
    med = float(np.median(lat))
    log(f"[{smi}] direct recommend(), batch {BATCH}: per-batch latency "
        f"median {med * 1e3:.1f} ms (min {min(lat) * 1e3:.1f}, max "
        f"{max(lat) * 1e3:.1f}) over 5 batches = {BATCH / med:.1f} users/s; "
        f"HTTP burst {N_REQUESTS / burst_s:.1f} users/s; peak device memory "
        f"{peak_gb:.2f} GB (max_memory_allocated)")
    b11 = serve_int8_catalog(smi, rec, histories, direct)
    int8 = serve_int8(smi, rec, histories, direct, med)
    return {"launches": dict(launches, b11=b11["launches"]), "k1_err": err,
            "k2_err": k2_err, "b11_err": b11["err"], "int8": int8,
            "stack": (rec, histories)}


def serve_int8_catalog(smi: str, rec, histories, direct) -> dict:
    """A second Recommender over the same model and catalog, ranking over the
    int8 catalog (quantize_rows + B11)."""
    from unirec_tpu_torch.ops.losses import l2_normalize
    from unirec_tpu_torch.ops.quantization import retrieve_top_k_int8
    from unirec_tpu_torch.serving.recommender import Recommender

    qrec = Recommender(rec.model, rec.tokenizer, rec.item_dict, rec.cache,
                       dict(zip(rec.catalog_ids, rec.catalog)),
                       batch_size=BATCH, quantize_catalog=True)
    seen = {}
    hook = qrec.model.register_forward_hook(
        lambda mod, args, out: seen.__setitem__("pooled", out))
    try:
        retrieve_top_k_int8.launches = 0
        answers = qrec.recommend(histories, k=SERVE_K)
        launches = retrieve_top_k_int8.launches
    finally:
        hook.remove()
    log(f"int8 catalog ({qrec._catalog_q.numel() / 1e6:.1f} MB of codes): "
        f"{len(answers)} answers, B11 launches {launches}")
    if launches == 0:
        raise AssertionError("B11 was not launched by the int8-catalog run")
    overlap = []
    for h, got, want in zip(histories, answers, direct):
        ids = [r.item_id for r in got]
        scores = [r.score for r in got]
        if len(got) != SERVE_K or set(ids) & set(h):
            raise AssertionError(f"bad int8-catalog answer {ids}")
        if scores != sorted(scores, reverse=True):
            raise AssertionError(f"int8-catalog scores not descending {scores}")
        overlap.append(len(set(ids) & {r.item_id for r in want}) / SERVE_K)
    log(f"int8-catalog answers valid: {SERVE_K} items, no history items, "
        f"scores descending; top-{SERVE_K} overlap with the float32 catalog's "
        f"answers mean {np.mean(overlap):.3f}, min {min(overlap):.3f} "
        "(reported, not gated)")
    with torch.no_grad():
        users = l2_normalize(seen["pooled"]).float()
        err = b11_compare(users, qrec._catalog_q, qrec._catalog_scales,
                          SERVE_K + qrec.jc.num_history_items)
    lat = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qrec.recommend(histories[:BATCH], k=SERVE_K)
        lat.append(time.perf_counter() - t0)
    med = float(np.median(lat))
    log(f"[{smi}] int8-catalog recommend(), batch {BATCH}: per-batch latency "
        f"median {med * 1e3:.1f} ms (min {min(lat) * 1e3:.1f}, max "
        f"{max(lat) * 1e3:.1f}) over 5 batches")
    return {"launches": launches, "err": err}


def model_checksum(model) -> list:
    """Exact checksum of every tensor of the module: the sum of its bytes and
    its address, in state_dict order."""
    return [(k, int(v.contiguous().view(torch.uint8).sum(dtype=torch.int64)),
             v.data_ptr()) for k, v in model.state_dict().items()]


def user_cosines(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per-user cosine in float64 (the bf16-normalised embeddings are not
    exactly unit length)."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


def int8_launches():
    from unirec_tpu_torch.ops import fused_qwen3_int8 as pf
    from unirec_tpu_torch.ops.int8_matmul import int8_linear

    return {"b8": int8_linear, "b9a": pf.qkv_int8, "b9b": pf.swiglu_mlp_int8}


def serve_int8(smi: str, rec, histories, direct, bf16_med: float) -> dict:
    """The int8 serving slice on the serving stack's model: (a)
    precision="int8" with the adapters live (B8 on every projection), (b)
    merge_lora=True (B9a, B9b, and B8 on o_proj), (c) the same merged model
    with fused_blocks=False (B8 everywhere), each against the bf16
    recommender; then the HTTP burst through (b)."""
    from unirec_tpu_torch.ops import fused_qwen3_int8 as pf
    from unirec_tpu_torch.ops.int8_matmul import int8_linear, int8_linear_plain
    from unirec_tpu_torch.serving.recommender import Recommender
    from unirec_tpu_torch.serving.server import make_server

    shared = rec.model
    before = model_checksum(shared)
    catalog = dict(zip(rec.catalog_ids, rec.catalog))
    n_layers = shared.qwen_config.num_hidden_layers
    batches = -(-len(histories) // BATCH)
    u_bf16 = rec.encode_users(histories)
    counters = int8_launches()
    modes = {"a": dict(), "c": dict(merge_lora=True, fused_blocks=False),
             "b": dict(merge_lora=True)}
    want = {"a": {"b8": 7 * n_layers, "b9a": 0, "b9b": 0},
            "b": {"b8": n_layers, "b9a": n_layers, "b9b": n_layers},
            "c": {"b8": 7 * n_layers, "b9a": 0, "b9b": 0}}
    users = {}
    for key, kw in modes.items():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        r8 = Recommender(shared, rec.tokenizer, rec.item_dict, rec.cache,
                         catalog, batch_size=BATCH, precision="int8", **kw)
        for fn in counters.values():
            fn.launches = 0
        answers = r8.recommend(histories, k=SERVE_K)
        launches = {n: fn.launches for n, fn in counters.items()}
        per_batch = {n: want[key][n] * batches for n in want[key]}
        users[key] = r8.encode_users(histories)
        cos = user_cosines(users[key], u_bf16)
        overlap = [len({r.item_id for r in got} & {r.item_id for r in ref})
                   / SERVE_K for got, ref in zip(answers, direct)]
        lat = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r8.recommend(histories[:BATCH], k=SERVE_K)
            lat.append(time.perf_counter() - t0)
        med = float(np.median(lat))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        log(f"[{smi}] int8 ({key}) {kw or 'adapters live'}: launches over "
            f"{batches} batches {launches} (want {per_batch}); user cosine "
            f"vs bf16 min {cos.min():.5f} mean {cos.mean():.5f} (tol "
            f"{INT8_VS_BF16_COS}); top-{SERVE_K} overlap with bf16 mean "
            f"{np.mean(overlap):.3f} min {min(overlap):.3f}; batch {BATCH} "
            f"latency median {med * 1e3:.1f} ms (min {min(lat) * 1e3:.1f}, "
            f"max {max(lat) * 1e3:.1f}) vs bf16 {bf16_med * 1e3:.1f} ms; peak "
            f"device memory {peak_gb:.2f} GB")
        if launches != per_batch:
            raise AssertionError(f"int8 ({key}) launches {launches}, want "
                                 f"{per_batch}")
        if not cos.min() >= INT8_VS_BF16_COS:
            raise AssertionError(f"int8 ({key}) user embeddings fail the "
                                 "quality class against bf16")
        for h, got in zip(histories, answers):
            ids = [r.item_id for r in got]
            if len(ids) != SERVE_K or set(ids) & set(h):
                raise AssertionError(f"bad int8 ({key}) answer {ids}")
        if key != "b":
            del r8
    fused = r8  # (b), built last: the others are gone before its peak
    fused_vs_controls(shared, rec, catalog, histories, users)

    # (b) through HTTP, answers equal to direct recommend()
    server, batcher = make_server(fused, port=0, warmup=True,
                                  max_queued=N_REQUESTS)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    seen = {}
    layer0 = fused.model.base_model.layers[0]
    hooks = [
        layer0.self_attn.register_forward_pre_hook(
            lambda mod, args: seen.__setitem__("attn", args[0])),
        layer0.self_attn.o_proj.register_forward_pre_hook(
            lambda mod, args: seen.__setitem__("o_proj", args[0])),
        layer0.mlp.register_forward_pre_hook(
            lambda mod, args: seen.__setitem__("mlp", args[0])),
    ]
    try:
        for fn in counters.values():
            fn.launches = 0
        batches_before = batcher.batches_run
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=N_REQUESTS) as pool:
            answers = list(pool.map(
                lambda h: post(f"{base}/recommend", {"history": h,
                                                     "k": SERVE_K}),
                histories))
        burst_s = time.perf_counter() - t0
        http_launches = {n: fn.launches for n, fn in counters.items()}
        burst_batches = batcher.batches_run - batches_before
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
    finally:
        for h in hooks:
            h.remove()
        server.shutdown()
        server.server_close()
        batcher.close()
        thread.join(timeout=30)
    want_http = {n: n_layers * burst_batches for n in counters}
    log(f"int8 (b) served {N_REQUESTS} requests over HTTP in {burst_s:.3f} s "
        f"({burst_batches} batches; {health['batches_run']} with the warmup); "
        f"launches during the requests {http_launches} (want {want_http})")
    if not (burst_batches > 0 and http_launches == want_http):
        raise AssertionError(f"int8 (b) HTTP launches {http_launches}, want "
                             f"{want_http}")
    direct8 = fused.recommend(histories, k=SERVE_K)
    for h, (status, out), ref in zip(histories, answers, direct8):
        ids = [r["item_id"] for r in out.get("items", [])]
        scores = [r["score"] for r in out.get("items", [])]
        if status != 200 or len(ids) != SERVE_K or set(ids) & set(h):
            raise AssertionError(f"bad int8 HTTP answer {status} {out}")
        if ids != [r.item_id for r in ref] or not np.allclose(
                scores, [r.score for r in ref], atol=1e-5, rtol=0):
            raise AssertionError("int8 HTTP answer differs from recommend()")
        if scores != sorted(scores, reverse=True):
            raise AssertionError(f"int8 HTTP scores not descending {scores}")
    log(f"{N_REQUESTS}/{N_REQUESTS} int8 HTTP answers valid and equal to "
        "direct recommend()")

    # the kernels on the tensors the served run fed layer 0
    attn, mlp = layer0.self_attn, layer0.mlp
    d = shared.qwen_config.hidden_size
    with torch.no_grad():
        x = seen["attn"].reshape(-1, d)
        errs = {"b9a": check_int8_linear(
            "B9A", pf.qkv_int8(x, attn.qkv_q, attn.qkv_scale),
            pf.qkv_int8_plain(x, attn.qkv_q, attn.qkv_scale), "served layer 0")}
        ctx = seen["o_proj"].reshape(-1, seen["o_proj"].shape[-1])
        o = attn.o_proj
        errs["b8"] = check_int8_linear(
            "B8", int8_linear(ctx, o.weight_q, o.weight_scale),
            int8_linear_plain(ctx, o.weight_q, o.weight_scale),
            "served layer 0 o_proj")
        x = seen["mlp"].reshape(-1, d)
        args = (x, mlp.gate_up_q, mlp.gate_up_scale, mlp.down_proj.weight_q,
                mlp.down_proj.weight_scale)
        errs["b9b"] = check_swiglu(pf.swiglu_mlp_int8(*args),
                                   pf.swiglu_mlp_int8_plain(*args),
                                   "served layer 0")

    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fused.encode_users(histories[:BATCH])
        torch.cuda.synchronize()
    rows = device_time_by_kernel(prof)
    total = sum(t for _, t in rows)
    log(f"[{smi}] int8 (b): one batch of {BATCH} users under torch.profiler: "
        f"{total:.2f} ms of device time in {len(rows)} kernels"
        + ("" if rows else " (no device rows: breakdown not measured)"))
    for name, t in rows[:12]:
        log(f"  {t:9.3f} ms {100 * t / total:5.1f}%  {name[:110]}")

    after = model_checksum(shared)
    if after != before or shared.lora is None or (
            shared.qwen_config.fused_int8_inference):
        raise AssertionError("an int8 recommender changed the shared model")
    log(f"the shared bf16 model is unchanged: {len(before)} tensors, checksum "
        f"{sum(c for _, c, _ in before)} before and after")
    del fused
    return {"launches": http_launches, "errs": errs}


def fused_vs_controls(shared, rec, catalog, histories, users) -> None:
    """(b) against (c), and the two controls that split their gap: (c)'s
    merged model with every MLP's output replaced by a plain version on the
    card, (c32) B9b's and (c16) the per-projection chain's."""
    import torch.nn.functional as F

    from unirec_tpu_torch.ops import fused_qwen3_int8 as pf
    from unirec_tpu_torch.ops.int8_matmul import int8_linear_plain
    from unirec_tpu_torch.serving.recommender import Recommender

    def plain_mlp(mlp, args, out):
        x = args[0].reshape(-1, args[0].shape[-1])
        down = mlp.down_proj
        if fp32_mid:
            y = pf.swiglu_mlp_int8_plain(x, mlp.gate_up_q, mlp.gate_up_scale,
                                         down.weight_q, down.weight_scale)
        else:
            g, u = (int8_linear_plain(x, p.weight_q, p.weight_scale)
                    for p in (mlp.gate_proj, mlp.up_proj))
            y = int8_linear_plain(F.silu(g) * u, down.weight_q,
                                  down.weight_scale)
        return y.reshape(out.shape)

    ctl = Recommender(shared, rec.tokenizer, rec.item_dict, rec.cache, catalog,
                      batch_size=BATCH, precision="int8", merge_lora=True,
                      fused_blocks=False)
    hooks = [layer.mlp.register_forward_hook(plain_mlp)
             for layer in ctl.model.base_model.layers]
    try:
        for key, fp32_mid in (("c32", True), ("c16", False)):
            users[key] = ctl.encode_users(histories)
    finally:
        for h in hooks:
            h.remove()
    del ctl
    cos = {pair: user_cosines(users[pair[0]], users[pair[1]])
           for pair in (("b", "c"), ("b", "c32"), ("c", "c16"),
                        ("c32", "c16"))}
    gap = cos["b", "c"] - cos["c32", "c16"]
    log("int8 user cosine, min / mean over users (same merged weights; c32 "
        "and c16 are (c) with B9b's and the per-projection chain's plain "
        "MLP): " + "; ".join(
            f"({a}) vs ({b}) {c.min():.7f} / {c.mean():.7f}"
            for (a, b), c in cos.items())
        + f"; (b)/(c) minus the rounding alone, per user, min {gap.min():.2e} "
        f"max {gap.max():.2e} (tol {FUSED_VS_CONTROL_COS} for the first "
        f"pair's controls, -{ROUNDING_GAP_MARGIN:g} for the gap)")
    if not (cos["b", "c32"].min() >= FUSED_VS_CONTROL_COS
            and cos["c", "c16"].min() >= FUSED_VS_CONTROL_COS):
        raise AssertionError("an int8 path disagrees with its plain control")
    if not gap.min() >= -ROUNDING_GAP_MARGIN:
        raise AssertionError("the fused blocks sit further from the "
                             "per-projection path than the rounding explains")


def phase_entry_point(smi: str, rec) -> dict:
    """serve_cli.build_recommender(parse_args([...])) with --precision int8
    --merge-lora on a saved full-width K=2 Item Q-Former checkpoint, a field
    cache directory and JSON item and catalog files of ENTRY_ITEMS items
    written from the serving stack; one batch answered through it."""
    from unirec_tpu_torch.cli import serve_cli
    from unirec_tpu_torch.utils.checkpoint import save_checkpoint

    ids = rec.catalog_ids[:ENTRY_ITEMS]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        save_checkpoint(os.path.join(tmp, "iq"), rec.model.qformer,
                        rec.model.qformer_config,
                        extra={"field_names": list(rec.cache.fields)})
        rows = rec.cache.rows_for(ids)
        type(rec.cache)(
            np.asarray(rec.cache.embeddings)[rows],
            np.asarray(rec.cache.masks)[rows], list(rec.cache.fields),
            list(ids)).save(os.path.join(tmp, "cache"))
        with open(os.path.join(tmp, "items.json"), "w") as fh:
            json.dump({i: rec.item_dict[i] for i in ids}, fh)
        with open(os.path.join(tmp, "catalog.json"), "w") as fh:
            json.dump({i: np.round(rec.catalog[j], 5).tolist()
                       for j, i in enumerate(ids)}, fh)
        args = serve_cli.parse_args([
            "--qformer-checkpoint", os.path.join(tmp, "iq"),
            "--cache-dir", os.path.join(tmp, "cache"),
            "--item-dict", os.path.join(tmp, "items.json"),
            "--catalog", os.path.join(tmp, "catalog.json"),
            "--precision", "int8", "--merge-lora", "--prewarm"])
        cli_rec = serve_cli.build_recommender(args)
        build_s = time.perf_counter() - t0
    hist = [list(ids[i * 7: i * 7 + i % 6]) for i in range(BATCH)]
    counters = int8_launches()
    for fn in counters.values():
        fn.launches = 0
    answers = cli_rec.recommend(hist, k=SERVE_K)
    launches = {n: fn.launches for n, fn in counters.items()}
    n_layers = cli_rec.model.qwen_config.num_hidden_layers
    log(f"serve_cli.build_recommender --precision int8 --merge-lora: "
        f"{len(cli_rec.catalog_ids)} items, built in {build_s:.1f} s (files "
        f"written and read); one batch of {BATCH}: launches {launches}")
    if launches != {"b8": n_layers, "b9a": n_layers, "b9b": n_layers}:
        raise AssertionError(f"serve_cli int8 launches {launches}")
    for h, got in zip(hist, answers):
        got_ids = [r.item_id for r in got]
        if len(got_ids) != SERVE_K or set(got_ids) & set(h) or not all(
                np.isfinite(r.score) for r in got):
            raise AssertionError(f"bad serve_cli answer {got_ids}")
    del cli_rec
    return {"launches": launches}


# -- phase 5: the item-token sweep ---------------------------------------------


def flops_per_item(cfg) -> float:
    """Projection and attention-core FLOPs per item, every layer's self block
    counted per item (the audit of bench.py, 10.88 GFLOP at production)."""
    d, k, f = cfg.hidden_size, cfg.num_query_tokens, cfg.num_fields
    dm, inter = cfg.field_embedding_dim, cfg.intermediate_size
    n_cross = len(range(0, cfg.num_hidden_layers,
                        cfg.qformer().cross_attention_freq))
    self_f = 2 * k * 4 * d * d + 2 * 2 * k * k * d
    ffn_f = 2 * k * 2 * d * inter
    cross_f = 2 * (k * 2 * d * d + f * 2 * dm * d) + 2 * 2 * k * f * d
    return cfg.num_hidden_layers * (self_f + ffn_f) + n_cross * cross_f


def token_cosines(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.cosine_similarity(
        a.float().reshape(-1, a.shape[-1]), b.float().reshape(-1, b.shape[-1]),
        dim=-1)


def device_time_by_kernel(prof) -> list:
    """(name, device ms) per device kernel from a torch.profiler run (the
    kernels' own rows, so that time under an aten op is not counted twice)."""
    rows = []
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0)
        if t > 0:
            rows.append((ev.key, t / 1e3))
    return sorted(rows, key=lambda r: -r[1])


def phase_sweep(smi: str) -> dict:
    """The CLI sweep at full width, bf16 (B1-B3) and then int8 (B4-B6), over
    one seed-0 checkpoint directory and one 9,000-item cache."""
    from unirec_tpu.configs import ItemQFormerConfig
    from unirec_tpu.data.cache import FieldEmbeddingCache
    from unirec_tpu_torch.utils.checkpoint import save_checkpoint
    from unirec_tpu_torch.utils.weights import init_item_qformer

    cfg = ItemQFormerConfig()
    fields = [f"f{i}" for i in range(cfg.num_fields)]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        model = init_item_qformer(cfg, gen, device="cuda", dtype=torch.float32)
        save_checkpoint(os.path.join(tmp, "ckpt"), model, cfg,
                        extra={"field_names": fields})
        rng = np.random.default_rng(SEED)
        n, f, dm = SWEEP_ITEMS, cfg.num_fields, cfg.field_embedding_dim
        emb = rng.standard_normal((n, f, dm), dtype=np.float32)
        masks = (rng.random((n, f)) > 0.15).astype(np.float32)
        masks[::1000] = 0.0  # items with no field at all
        emb *= masks[..., None]  # a missing field has a zero embedding
        ids = [f"item{j}" for j in range(n)]
        FieldEmbeddingCache(emb, masks, fields, ids).save(
            os.path.join(tmp, "cache"))
        n_params = sum(p.numel() for p in model.parameters())
        log(f"sweep set-up: ItemQFormerConfig() {cfg.num_hidden_layers} layers "
            f"x {cfg.hidden_size}, K={cfg.num_query_tokens}, F={f}, "
            f"intermediate {cfg.intermediate_size}; {n_params} parameters "
            f"(fp32 checkpoint); cache {n} x {f} x {dm}, "
            f"{int((masks == 0).sum())} missing fields, "
            f"{int((masks.sum(1) == 0).sum())} items without fields; made in "
            f"{time.perf_counter() - t0:.1f} s")
        empty = np.flatnonzero(masks.sum(1) == 0)  # every item without fields
        sample = np.sort(np.concatenate([
            empty, rng.choice(np.setdiff1d(np.arange(n), empty),
                              SWEEP_SAMPLE - len(empty), replace=False)]))
        inputs = dict(cfg=cfg, model=model, tmp=tmp, emb=emb, masks=masks,
                      ids=ids, fields=fields, sample=sample, n_empty=len(empty))
        return {precision: sweep_cli(smi, precision, **inputs)
                for precision in ("bf16", "int8")}


def sweep_cli(smi, precision, cfg, model, tmp, emb, masks, ids, fields, sample,
              n_empty) -> dict:
    from unirec_tpu.data.cache import FieldEmbeddingCache
    from unirec_tpu_torch.cli.generate_all_item_embeddings import main as cli
    from unirec_tpu_torch.inference.fused_qformer import fused_qformer_forward
    from unirec_tpu_torch.inference.qformer_inference import QFormerInference
    from unirec_tpu_torch.ops import fused_qformer_int8 as pq
    from unirec_tpu_torch.ops import fused_qformer_layer as fq

    n = len(ids)
    out_path = os.path.join(tmp, f"tokens_{precision}.pkl")
    progress_path = os.path.join(tmp, f"progress_{precision}.json")
    argv = ["--checkpoint", os.path.join(tmp, "ckpt"),
            "--cache-dir", os.path.join(tmp, "cache"),
            "--output", out_path, "--batch-size", str(SWEEP_BATCH),
            "--profile", "--progress-file", progress_path,
            "--precision", precision]
    bf16_blocks = (fq.fused_self_attention_block,
                   fq.fused_cross_attention_block, fq.fused_ffn_block)
    int8_blocks = (pq.fused_self_attention_block_q,
                   pq.fused_cross_attention_block_q, pq.fused_ffn_block_q)
    blocks, other, names = (
        (bf16_blocks, int8_blocks, ("b1", "b2", "b3")) if precision == "bf16"
        else (int8_blocks, bf16_blocks, ("b4", "b5", "b6")))
    for fn in blocks + other:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli(argv)
    cli_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in zip(names, blocks)}
    stray = sum(fn.launches for fn in other)
    if rc != 0:
        raise AssertionError(f"the {precision} sweep CLI returned {rc}")
    with open(progress_path) as fh:
        progress = json.load(fh)
    with open(out_path, "rb") as fh:
        tokens = pickle.load(fh)

    batches = -(-n // SWEEP_BATCH)
    n_layers = cfg.num_hidden_layers
    n_cross = len(range(0, n_layers, cfg.qformer().cross_attention_freq))
    want = dict(zip(names, (n_layers * batches, n_cross * batches,
                            n_layers * batches)))
    shape = (cfg.num_query_tokens, cfg.hidden_size)
    log(f"sweep CLI {precision}: rc {rc}, {len(tokens)} items in {cli_s:.2f} s "
        f"({n / cli_s:.1f} items/s end to end, checkpoint and cache loading "
        f"and the .pkl included; {progress['items_per_sec']} items/s in the "
        f"batch loop); fallback items {progress['fallback_items']}; launches "
        f"{launches} (want {want}), other precision's blocks {stray}")
    if len(tokens) != n or set(tokens) != set(ids):
        raise AssertionError("the sweep did not return every item")
    if not all(t.shape == shape and np.isfinite(t).all()
               for t in tokens.values()):
        raise AssertionError("a token array has the wrong shape or is not finite")
    if progress["fallback_items"] != 0:
        raise AssertionError("items took the per-item or zero-token fallback")
    if launches != want or stray:
        raise AssertionError(f"block launches {launches} (other precision "
                             f"{stray}), want {want}")

    # the engine the CLI ran, on the plain block functions, and the fp32 model
    inference = QFormerInference(
        config=cfg, params=model.state_dict(), field_names=fields,
        device="cuda", batch_size=SWEEP_BATCH, use_fused=True,
        precision=precision)
    emb_s = torch.from_numpy(emb[sample]).cuda()
    mask_s = torch.from_numpy(masks[sample]).cuda()
    got = torch.from_numpy(np.stack([tokens[ids[j]] for j in sample])).cuda()
    # the plain engine's own sensitivity: field 0 of every item one bf16 ulp
    # away (the engine casts the fields to bf16)
    nudged = emb_s.clone()
    e16 = nudged[:, 0, 0].bfloat16()
    nudged[:, 0, 0] = (e16.view(torch.int16) + 1).view(torch.bfloat16).float()
    with torch.inference_mode():
        plain = fused_qformer_forward(inference.fused_params, cfg, emb_s,
                                      mask_s, plain=True)
        plain_nudged = fused_qformer_forward(inference.fused_params, cfg,
                                             nudged, mask_s, plain=True)
        ref32 = model.query_outputs(emb_s, mask_s)
    plain_err = (got - plain.float()).abs().max().item()
    plain_cos = token_cosines(got, plain).min().item()
    floor_cos = token_cosines(plain, plain_nudged).min().item()
    cos32 = token_cosines(got, ref32)
    atol, min_cos = ((SWEEP_PLAIN_ATOL, SWEEP_PLAIN_COS) if precision == "bf16"
                     else (float("inf"), SWEEP_PLAIN_COS_INT8))
    log(f"sweep tokens {precision} on {len(sample)} sampled items ({n_empty} "
        f"without fields): vs the engine on plain blocks max|d| "
        f"{plain_err:.3e}, min token cosine {plain_cos:.7f} (tol "
        f"{atol:g} / {min_cos}; the plain engine against itself one input "
        f"ulp away: {floor_cos:.7f}); vs the fp32 ItemQFormer min token "
        f"cosine {cos32.min().item():.6f}, mean {cos32.mean().item():.6f} "
        f"(tol {SWEEP_FP32_COS})")
    if not (plain_err <= atol and plain_cos >= min_cos):
        raise AssertionError("sweep tokens disagree with the plain engine")
    if not cos32.min().item() >= SWEEP_FP32_COS:
        raise AssertionError(f"sweep tokens fail the {precision} quality gate")
    del ref32, plain, plain_nudged

    # throughput with inputs resident on the device, as bench.py measures
    emb_d = torch.from_numpy(emb[:SWEEP_BATCH]).cuda()
    mask_d = torch.from_numpy(masks[:SWEEP_BATCH]).cuda()

    def rate(fn, iters):
        fn()
        torch.cuda.synchronize()
        rates = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
                torch.cuda.synchronize()
            rates.append(SWEEP_BATCH * iters / (time.perf_counter() - t0))
        return sorted(rates)

    torch.cuda.reset_peak_memory_stats()
    before_gb = torch.cuda.memory_allocated() / 1e9
    fused = rate(lambda: inference.forward(emb_d, mask_d), 5)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with torch.inference_mode():
        plain_rates = rate(lambda: fused_qformer_forward(
            inference.fused_params, cfg, emb_d, mask_d, plain=True), 1)
    gflop = flops_per_item(cfg) / 1e9
    log(f"[{smi}] {precision} query_tokens_from_embeddings engine, batch "
        f"{SWEEP_BATCH} resident on the device: median {fused[1]:.1f} items/s "
        f"(min {fused[0]:.1f}, max {fused[2]:.1f}; 3 repeats of 5 synced "
        f"batches) = {fused[1] * gflop / 1e3:.1f} TFLOP/s at {gflop:.3f} "
        f"GFLOP/item; peak device memory {peak_gb:.2f} GB "
        f"(max_memory_allocated, weights included; {before_gb:.2f} GB was "
        f"allocated before the engine ran: the engine's weights, the fp32 "
        f"model and the inputs)")
    log(f"[{smi}] {precision} plain engine (plain block functions), same "
        f"inputs: median {plain_rates[1]:.1f} items/s (min "
        f"{plain_rates[0]:.1f}, max {plain_rates[2]:.1f})")
    log(f"[{smi}] {precision} sweep CLI end to end: {n / cli_s:.1f} items/s "
        f"over {n} items (one run)")

    # one CLI batch step by step: host gather, copy in, forward, copy out
    cache = FieldEmbeddingCache(emb, masks, fields, ids)
    batch_ids = ids[:SWEEP_BATCH]
    steps = {}
    for _ in range(2):  # the second pass is reported
        t0 = time.perf_counter()
        e_np, m_np = cache.gather(batch_ids)
        t1 = time.perf_counter()
        e_t, m_t = torch.from_numpy(e_np).cuda(), torch.from_numpy(m_np).cuda()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = inference.forward(e_t, m_t)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        out.float().cpu().numpy()
        t4 = time.perf_counter()
        steps = {"gather": t1 - t0, "to_device": t2 - t1, "forward": t3 - t2,
                 "to_host": t4 - t3}
    log(f"[{smi}] {precision}: one CLI batch of {SWEEP_BATCH} by step (ms): "
        + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in steps.items()))

    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        inference.forward(emb_d, mask_d)
        torch.cuda.synchronize()
    rows = device_time_by_kernel(prof)
    total = sum(t for _, t in rows)
    log(f"[{smi}] {precision}: one engine batch of {SWEEP_BATCH} under "
        f"torch.profiler: {total:.2f} ms of device time in {len(rows)} kernels"
        + ("" if rows else " (no device rows: breakdown not measured)"))
    for name, t in rows[:12]:
        log(f"  {t:9.3f} ms {100 * t / total:5.1f}%  {name[:110]}")
    del inference
    torch.cuda.empty_cache()
    return {"launches": launches}

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    cap = torch.cuda.get_device_capability(0)
    if cap < (9, 0):
        print(f"chip_smoke: needs compute capability 9.0, got {cap}",
              file=sys.stderr)
        return 2
    # fp32 matmuls stay full precision (no TF32) for the fp32 tolerances
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import unirec_tpu_torch  # noqa: F401  (fails outside a checkout)
    from unirec_tpu_torch.ops._build import load_kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    name = torch.cuda.get_device_name(0)
    log(f"device: {name}, capability {cap}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    kern = load_kernels()
    log(f"build: {kern.path.name} from unirec_tpu_torch/csrc in "
        f"{kern.build_seconds:.1f} s (load {time.perf_counter() - t0:.1f} s)")
    log(kern.ptxas_log.strip())

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    k1_times = phase_k1(gen)
    k2_times = phase_k2(gen)
    b11_times = phase_b11(gen)
    blocks = phase_blocks(gen, "bf16")
    for key, err in phase_wide_k(gen).items():
        blocks[key]["err"] = max(blocks[key]["err"], err)
    blocks.update(phase_blocks(gen, "int8"))
    qwen3_int8 = phase_qwen3_int8(gen)
    served = phase_serve(smi)
    phase_entry_point(smi, served.pop("stack")[0])
    gc.collect()  # the serving stacks, before the sweep's memory is read
    torch.cuda.empty_cache()
    swept = phase_sweep(smi)
    sweep_launches = {**swept["bf16"]["launches"], **swept["int8"]["launches"]}

    k1_ms, k1_plain = k1_times[torch.bfloat16]
    k2_ms, k2_plain = k2_times[BATCH]
    b11_ms, b11_plain = b11_times[BATCH]
    log(json.dumps({"kernels": [
        {"name": "flash_causal_fwd", "route": "cuda",
         "source": "unirec_tpu_torch/csrc/flash_causal_fwd.cu",
         "replaces": "unirec_tpu/ops/flash_causal_vjp.py:78",
         "launches": served["launches"]["k1"],
         "max_abs_err": served["k1_err"], "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "retrieve_topk", "route": "cuda",
         "source": "unirec_tpu_torch/csrc/retrieve_topk.cu",
         "replaces": "unirec_tpu/ops/ranking.py:118",
         "launches": served["launches"]["k2"],
         "max_abs_err": served["k2_err"], "ms": k2_ms, "plain_ms": k2_plain},
        {"name": "retrieve_topk_int8", "route": "cuda",
         "source": "unirec_tpu_torch/csrc/retrieve_topk.cu",
         "replaces": "unirec_tpu/ops/quantization.py:78",
         "launches": served["launches"]["b11"],
         "max_abs_err": served["b11_err"], "ms": b11_ms,
         "plain_ms": b11_plain},
    ] + [
        {"name": name, "route": "cuda",
         "source": "unirec_tpu_torch/csrc/qformer_blocks.cu",
         "replaces": f"unirec_tpu/ops/{src}:{line}",
         "launches": sweep_launches[key],
         "max_abs_err": blocks[key]["err"], "ms": blocks[key]["ms"],
         "plain_ms": blocks[key]["plain_ms"]}
        for key, name, src, line in (
            ("b1", "qformer_self_block", "fused_qformer_layer.py", 119),
            ("b2", "qformer_cross_block", "fused_qformer_layer.py", 174),
            ("b3", "qformer_ffn_block", "fused_qformer_layer.py", 421),
            ("b4", "qformer_self_block_q", "fused_qformer_int8.py", 90),
            ("b5", "qformer_cross_block_q", "fused_qformer_int8.py", 140),
            ("b6", "qformer_ffn_block_q", "fused_qformer_int8.py", 193))
    ] + [
        {"name": name, "route": "cuda",
         "source": "unirec_tpu_torch/csrc/qformer_blocks.cu",
         "replaces": f"unirec_tpu/ops/{src}",
         "launches": served["int8"]["launches"][key],
         "max_abs_err": max(qwen3_int8[key]["err"],
                            served["int8"]["errs"][key]),
         "ms": qwen3_int8[key]["ms"], "plain_ms": qwen3_int8[key]["plain_ms"]}
        for key, name, src in (
            ("b8", "int8_linear", "int8_matmul.py:37"),
            ("b9a", "qkv_int8", "fused_qwen3_int8.py:55"),
            ("b9b", "qwen3_swiglu_q", "fused_qwen3_int8.py:163"))
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
