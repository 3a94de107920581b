"""Smoke run of the PyTorch port's main paths on one NVIDIA Hopper GPU: the
serving path (over a float32 and an int8 catalog, and with the W8A8 int8
Qwen3 forward), the item-token sweep (bf16 and W8A8 int8), the pipeline's
front end (data, the item encoders' towers, ``tokens --data``, ``users``),
joint training, Item Q-Former training and User Q-Former training, their
data (and the user stage's sequence) parallelism on one card; and the
two kernels no path of the JAX package calls (B14p, B15) through their own
entry points.

    python3 chip_smoke.py

Phases (any failed check raises; the script then exits non-zero):

1. device: ``nvidia-smi`` name and power limit, torch's device name and
   compute capability.  No CUDA device of capability (9, 0) -> exit 2.
2. build: the hand-written CUDA kernels from ``unirec_tpu_torch/csrc`` (one
   nvcc per source for sm_90a, started together; ``-Xptxas -v`` printed).
3. kernels vs plain versions at the slices' shapes, timed with CUDA events:
   K1 causal GQA flash attention (B=8, L=512, 16/8 heads, hd 128, row lengths
   1..512) in fp32 and bf16, beside ``scaled_dot_product_attention`` (the
   yardstick, never called by the port); K1's training form (o, m, l) and
   B7b, the flash backward's dq and dk/dv kernels, at the same shape with
   random right padding, against their plain versions, and the kernels'
   forward + backward beside the plain path and SDPA's; K1 and B7b also at
   hd 64 and 32 (B=4, L=512, 16/8 heads, a row whose last three key tiles
   are padding), every one repeated for identical bits; a tiny Qwen3 at
   head_dim 64 and 16 (C-4) whose bf16 forward and flash-VJP backward run
   through K1 and B7b (counted), held to its plain attention path; K2 blocked top-k
   retrieval (8 and 64 users, 20,000 x 1,024 catalog, k=20) and B11, the same
   over the catalog quantized to int8; B1/B2/B3, the Item Q-Former's self,
   cross and FFN blocks in bf16 at production widths (hidden 1024, 16 heads,
   K=32, F=14, intermediate 4096) for 4096 and a ragged 1001 items (B1 also
   at the 1-item layer-0 shape), with ~15% missing fields and >= 8 items
   that have none; B1/B2 at K=128 and 256 (64 items), and at 4 heads of
   256 and 300 fields per item (64 items, K=32), timed; the device time of
   each launch inside B1, B2 and B3 (GEMMs, attention, the LayerNorm in the
   residual GEMM's cluster epilogue) from ``torch.profiler``, repeats bit
   for bit, and cuBLAS's time for each block's products alone (the
   yardstick); the residual GEMM's LayerNorm on both routes (the cluster
   epilogue against WG_BIAS_RESID + layer_norm_kernel through a test entry,
   at the sweep's two residual products and at widths 896 and 1032, timed)
   and B1-B3 at hidden 896 (a cluster with a ragged last tile) and 2304
   (two passes) at 4096 items; B4/B5/B6, the W8A8
   blocks, as B1-B3; B8, the W8A8 linear, at the Qwen3-0.6B serving
   projections (4096 rows: 1024->2048, 1024->1024, 2048->1024, 1024->3072,
   3072->1024; and 1024->2048 at 16384 rows), B9a (q|k|v, [4096, 1024] ->
   4096) and B9b (the SwiGLU MLP, [4096, 1024], intermediate 3072), each
   with the device time of each launch and ``torch._int_mm``'s time for its
   products alone (the yardstick); the int8 GEMM they and B4-B6 share in
   each of its epilogues against its plain form, bit for bit; B12s and
   B12c, the trainable self- and cross-attention blocks, forward and
   backward, at the item-training shape (512 and a ragged 509 items, ~15%
   missing fields, >= 8 items with none), each repeated for identical bits,
   the forwards beside ``multi_head_attention_forward`` (the yardstick),
   the device time of each launch inside them (GEMMs, attention), B12s at
   the user stage's 64 users of 64 query rows, and the four B12 kernels at
   the shapes of their gate the old kernels refused (K = F = 128 at head
   dim 128, K = F = 64 at 512, one head of 1024, hidden 1020 in 4 heads),
   timed; B13 (the streaming cross-attention) and B14 (the trainable merged-head
   cross-attention, forward and backward) at the user stage's shape (64
   users, 64 queries over 1,600 memory rows, 16 heads of 64) and over a
   ragged 1,000-row memory, with ~15% masked keys and one user masked
   whole, and over the ragged memory in 32 heads of 32 and 8 of 128, in
   fp32 and bf16, each repeated for identical bits, timed beside
   ``scaled_dot_product_attention`` (the yardstick); B14p, the trainable
   per-head cross-attention, driven through ``flash_cross_attention_vjp``
   and ``torch.autograd.grad`` (counted launches) at the user shape in
   per-head layout, the ragged memory and the JAX tests' shape (2 x 3 heads
   x 16 queries over 384 keys, hd 32), fp32 and bf16: output and gradients
   against the plain path, forward and backward kernels against their
   plain versions, repeats, masked keys' zero gradients; B15, the packed
   item attention, driven through ``packed_item_attention`` (counted) at
   the sweep's self (4096 items x 16 heads, K = F = 32, hd 64) and cross
   (F = 14) shapes, a ragged 1,001 items with ~15% missing fields and 9
   items with none, and K = 2 (hd 32), fp32 and bf16, against its plain
   version, repeats, items without a field against their values' mean;
   both timed beside SDPA.
3a. fp32 fused (``phase_fp32_fused``): the fp32 forms, at production
   widths.  B1-B3 at float32 and B4-B6 at float32 activations on 1,024
   items (~15% missing fields, >= 8 items with none) against their plain
   versions (B1-B3 max|d| / max|ref| <= 1e-5; B4-B6 the int8 blocks' gate,
   x's int8 codes in B6 those of the plain ``row_quant`` of the float32 x
   bit for bit), repeated for identical bits with exact launch counts;
   B12s/B12c at float32, forward and backward, at 512 items against their
   plain versions (<= 1e-5 relative, C-11's rule), repeated, then through
   ``fused_self/cross_attention_train`` and ``torch.autograd.grad``
   (counted launches); each timed beside its plain version, its bound and
   cuBLAS fp32 (B1-B3's products alone) or ``multi_head_attention_forward``
   in fp32 (B12's forwards).  Then the fused engine at
   ``ItemQFormerConfig()`` (12 layers) on 1,024 items:
   ``prepare_fused_params(model, cfg, dtype=torch.float32)`` against the
   plain fp32 ``ItemQFormer`` forward (max|d| / max|ref| <= 1e-4, per-token
   cosine >= 0.99999) and with ``precision="int8"`` (per-token cosine >=
   0.999, the int8 quality gate); exact launch counts (those of the fp32
   rows), items/s and peak memory.
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
   through B9a, B9b and B8.  A bf16 batch's ``torch.profiler`` breakdown by
   kernel and its device idle share are printed beside its latency.
5. the item-token sweep at full width (``ItemQFormerConfig()``, random
   weights from seed 0 saved as a checkpoint directory; a 9,000-item field
   cache from the seed): the port's ``generate_all_item_embeddings.main`` at
   batch 4096, once with ``--precision bf16`` and once with ``int8``; each
   run's output, fallback count and block launch counts checked (B1-B3 or
   B4-B6, 12/6/12 per batch, none of the other precision's), its tokens held
   to the engine on the plain block functions and to the fp32
   ``ItemQFormer``; items/s, TFLOP/s, peak memory and a ``torch.profiler``
   breakdown by kernel.
5b. the quality gates of ``unirec_tpu_torch/scripts`` (``phase_quality``,
   after phase 5): the engine gate (the bf16 and int8 engines at
   ``ItemQFormerConfig()``, batch 512, against the fp32 model, per-token
   cos_min >= 0.999), the serving gate (``Qwen3Config()``, seq 512, 64
   users at batch 16, 2,000 items: bf16, int8_xla and int8_fused against the
   fp32 oracle, per-user cosine >= 0.9995, 0.999 and 0.999) and the
   ``--int8-base`` convergence gate (the joint stage's model, 800 steps
   exact and with ``int8_base`` from one init: |dRecall@10| <= max(0.05,
   2.5 / n_test), |dMRR| <= 0.05), each kernel's exact launches (B1-B6; K1;
   B8, B9a, B9b; B8's fp32 form in the int8-base run), B8's fp32 form held
   bit for bit to its plain version at the convergence model's projections
   and timed at [4096, 1024] -> 2048, and the phase's seconds.  A serving
   mode that misses its gate runs again on the plain path (K1, B8, B9a,
   B9b replaced by their plain versions): if that passes, the kernels fail
   the phase; if it misses too (C-18: the W8A8 forward's own miss), the
   FAIL line stands, int8_xla's error is split between the attention's and
   the MLP's W8A8 projections, and the mode is held to the fp32 oracle at
   ``C18_FLOOR`` (a distance 1.2 times the gate's) and to the plain path at
   ``PLAIN_PATH_COS`` (0.9995).
5a. the pipeline's front end: ``data`` (the five subcommands of
   ``cli/data_pipeline.py``) over seeded raw files of 2,000 items and 1,000
   users; the Qwen3-Embedding text backend at full width (``Qwen3Config()``,
   seed-0 bf16 weights, max_length 128, batch 64) on 512 item texts of the
   triplet dict, with 28 K1 launches a batch, its pooled rows held to the
   same backend on the plain attention path (row cosine >= 0.999), K1 held
   to its plain version on layer 0's q, k and v (the bf16 K1 gate) and timed
   at that shape (B 64, L 128) beside SDPA; the CLIP ViT-L/14 vision tower
   (batch 32) and the CLIP text tower (batch 128, L 77) through their
   backends in bf16 against the same weights in fp32 (row cosine >= 0.99),
   images/s and texts/s; ``tokens --data`` at batch 4096 over phase 5's
   checkpoint saved with the default schema's 14 fields (``ItemEncoder()``
   then B1-B3, launch counts checked); ``users`` over phase 4's serving files
   (K1 launches checked), with the field cache on and off the device (row
   cosine >= 0.999, users/s each), and ``python3 -m unirec_tpu_torch users``
   as a subprocess.
6. joint training at full width (``Qwen3Config()``, LoRA r=16 on the seven
   projections, the sweep's ``ItemQFormerConfig()`` checkpoint, L=512, batch
   8, 10 history items x 14 fields x 1024, 10 negatives; bf16 compute with
   float32 masters and a bf16 frozen base): one step's loss and gradients
   with flash-VJP attention (28 launches each of K1, B7b dq and B7b dk/dv),
   on the plain attention path (none) and under remat (K1 56: the
   recompute), held to each other per trainable leaf; ms per step and peak
   memory, flash-VJP and plain; a ``torch.profiler`` breakdown of one step.
   Then ``cli.train_cli.main(["joint", ...])`` over files written here
   (train and validation JSON, 1,500 1024-d candidate embeddings, the item
   dict, the sweep's cache): 3 steps with ``--flash-vjp --no-remat``,
   evaluations and a checkpoint; ``--resume`` from it; one step with
   ``--int8-base`` (B8 196 times: 7 x 28).
7. Item Q-Former training at full width over the sweep's checkpoint and
   cache (batch 512, bf16 compute with float32 masters): one step with the
   plain anchor (the reference), then one with the fused anchor (B12s/B12c
   12/12/6/6 launches) on the plain step's active set of the contrastive
   hinge, B1/B2/B3 24/12/24 for the positive and negative forwards in both;
   the fused forward held to the plain one sample by sample (anchor
   representation, each hinge argument within its Lipschitz bound), loss
   and every leaf's gradient held to each other; a 10-step trajectory
   of each from one init; ms per step and peak memory of the plain anchor,
   the fused anchor, and the fused anchor with int8 references (B4-B6), the
   step split and a ``torch.profiler`` breakdown.  Then
   ``cli.train_cli.main(["item-qformer", ...])`` over item and sequence
   JSON written for the cache (2 epochs with ``--bf16 --fused-anchor``, then
   ``--resume``, then ``--int8-ref``; exact launch counts), ``evaluate`` on
   its checkpoint, ``QFormerInference`` on it against the fp32 model, and
   ``precompute`` of 2,000 items in the default field schema.
8. User Q-Former training at full width (``UserQFormerConfig()`` over the
   sweep's checkpoint and cache, --max-seq-len 50, batch 64, bf16 compute
   with float32 masters): the catalog's item tokens by
   ``precompute_item_tokens``; one step with ``--flash --fused`` (B14 and
   B12s 4 launches each way) against the plain step (none) from one init
   at dropout 0, loss and every leaf's gradient held to each other; ms per
   step, the forward + backward / optimizer split and peak memory of both,
   and a ``torch.profiler`` breakdown.  Then
   ``cli.train_cli.main(["user-qformer", ...])`` over history and review
   JSON written for the cache (``--bf16 --flash --fused`` for 2 epochs,
   ``--resume`` for 1, then ``--bf16 --remat`` for 1, whose evaluation
   launches B13 4 times a batch); exact launch counts, finite metrics.
   Then the step at 2 heads of 512 (the chunked B14) in bf16 and at
   float32 compute (the train CLI's default precision: B14 in the 3xTF32
   cluster form in every cross layer, the self blocks plain) held to the
   plain step, with B14's device time a step and the forms asserted, and
   the bf16 step at one head of 1024.
8a. A9's data and sequence parallelism on this one-card machine
   (``phase_parallel_serve`` after phase 4's entry point, ``phase_parallel``
   last): serving at dp = 2 over [cuda:0, cuda:0] (replicas that share the
   card) against dp = 1 on the float32 catalog, the int8 catalog and int8
   (b) (user rows at cosine >= 0.9999, ids equal but near-ties, K1 / K2 /
   B11 / B8 / B9a / B9b launched by the dp run); the sweep at batch 4096,
   bf16 and int8, dp = 2 against dp = 1 (B1-B6's max|d| gate, twice the
   launches); the joint (flash-VJP, batch 8), item (batch 512, fused
   anchor, int8 references), user (batch 64, seq 50, ``--flash --fused``)
   and user-sp (plain attention, 1,600 memory rows over sp = 2) steps on
   one rank, then the joint step through the dp code on a world-size-1
   NCCL group (bit for bit the plain step), then every case on two gloo
   ranks that share cuda:0 (losses and gradients held to one rank's by
   phase 6's gates, the ranks' parameters bit for bit equal, each rank's
   launches one rank's); ms per step, the gradient all-reduce, items/s
   (one card: no scaling figure); and ``train joint --dp 2`` refused,
   naming the card count.
8b. A9's tensor and pipeline parallelism (``phase_tp_pp``, after
   ``phase_parallel``): K1 at tp = 2's local heads (Hq 8, Hkv 4, hd 128, B
   8, L 512) against its plain version; the joint step at full width
   (batch 8, L 512, no remat, dropout 0, the plain attention, which tp and
   pp take) on one rank; the one-rank trainer's and the pipeline's code
   (pp = 1, one microbatch) on a world-size-1 NCCL group, bit for bit the
   plain step; tp = 2 and pp = 2 (M = 2) on two gloo ranks sharing cuda:0
   against one rank (losses within 1e-3, gradient cosine >= 0.999 but the
   noise leaves, the replicated parameters bit for bit equal), the tp = 2
   eval forward's user vectors at cosine >= 0.99999 in float32, and in
   bf16 no farther from one rank's float32 users than one rank's bf16
   users are, times the row layers' rounding ratio squared
   (``tpp_rounding``: bf16 column halves against the whole product's
   columns, two rounded row partials against one product), with K1
   launched 28 times a forward on each rank; ms per step, peak memory per
   rank, the activation all-reduce's and the microbatch send's ms (one
   card: no scaling figure); ``train joint --tp 2`` and ``--pp 2``
   refused, naming the card count.
9. the ``kernels`` JSON line (time, plain time, bound and what bounds it,
   the PyTorch yardstick where one call computes the same function; K1 a
   second time at the text tower's shape, its launches the text backend's;
   the B7b
   rows also ``path_ms``, the kernels' forward + backward through autograd,
   the like of their ``library_ms``), then the last line ``{"ok": true,
   ...}``.

TF32 stays off for both matmul flags: float32 products are full precision,
so the fp32 tolerances below hold.
"""

from __future__ import annotations

import contextlib
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
# K1 and B7b at the other head dims the kernels take (C-4), GQA 2:1: a row
# whose last three key tiles are all padding, a 129-key row, a 5-key row;
# hd 8 and 24 run zero-padded to 16 and 32, 256 is an instance of its own
CAUSAL_OTHER = dict(B=4, L=512, HQ=16, HKV=8, HD=(64, 32, 8, 24, 256),
                    LENGTHS=(512, 320, 129, 5))
K2_TIE, K2_SCORE_TOL = 1e-6, 1e-5
# K2 / B11 times: device ms a call from torch.profiler (the kernels' own
# rows, not the wrappers' host enqueue), each call after a 128 MB buffer is
# written and read (the catalog leaves L2, and no dirty line of the buffer
# is written back inside the measured kernels), as the serving path meets
# the catalog after its 28-layer forward; warm (back-to-back) logged beside
L2_FLUSH_BYTES = 128 << 20
RETRIEVAL_KERNELS = ("topk_share_kernel", "topk_merge_kernel")
# K2 and B11 off the serving shapes (users, rows, width, k): C-13's widths
# and the partition's edges (one row, fewer rows than SMs, a share one row
# short, two user groups); every catalog has a zero row and runs of equal
# rows across each share boundary, and the (8, 20,000, 1021) case runs once
# more with every score negative
RETRIEVAL_EDGES = ((1, 1, 1021, 1), (24, 37, 1021, 32), (8, 20_000, 1021, 20),
                   (64, 20_000, 1021, 20), (200, 20_001, 1021, 20),
                   (64, 20_001, 1024, 32))
# B1-B3 (bf16 in and out) against their plain versions on the same inputs, in
# fp32: the kernels sum in another order than the plain version, which can
# flip a bf16 rounding of qkv, probabilities, ctx or the gelu output and move
# a unit-scale LayerNorm output by a few bf16 ulps
BLOCK_ATOL, BLOCK_COS = 5e-2, 0.9999
QF_D, QF_HEADS, QF_K, QF_F, QF_INTER = 1024, 16, 32, 14, 4096
BLOCK_ITEMS = (4096, 1001)
# B12s / B12c at the item-training batch (and a ragged one), and B13 / B14,
# against their plain versions: relative to max|ref| (in bf16 the backward
# chains three products, as B7b's bound), and in bf16 per-row cosine as B1-B6
B12_ITEMS = (512, 509)
KERNEL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
KERNEL_COS = 0.9999
# B14's and B14p's bf16 dq / dk rows whose plain norm is below this share of
# the largest row's leave the cosine test (the max|d| bound still holds
# them): with one query, dk's row for key j is ds_j q, and a ds_j near zero
# leaves rounding noise on both sides (C-11: rows of 1e-10 and 2e-9 against
# 0.75, neither side parallel to q; every other row of 40 draws is)
GRAD_NOISE_FLOOR = 1e-6
# B1/B2 at K up to 256 query rows per item, at a head dim above 128 (4
# heads of 256) and at 300 fields per item, 64 items
WIDE_K, WIDE_K_ITEMS = (128, 256), 64
WIDE_BLOCKS = ((4, QF_F), (QF_HEADS, 300))  # (heads, fields) at K = 32
# B12 at shapes of its gate beyond the old kernels' (items, K, F, hidden,
# heads): K = F = 128 at hd 128, hd 512, one head of 1024, hidden 1020
B12_SHAPES = ((128, 128, 128, 1024, 8), (128, 64, 64, 1024, 2),
              (64, 64, 64, 1024, 1), (512, 32, 14, 1020, 4))
SWEEP_ITEMS, SWEEP_BATCH, SWEEP_SAMPLE = 9000, 4096, 256
# B15 at shapes the first kernel refused (C-8): (items, K, F, hd, missing)
B15_SHAPES = ((256, QF_K, QF_F, 256, 0.15), (256, QF_K, QF_F, 512, 0.15),
              (64, 128, 512, 64, 0.15), (BLOCK_ITEMS[1], 2, 600, 32, 0.15))
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
# the card's published peaks (NVIDIA H100 SXM data sheet, dense): the least
# time a kernel could take is the larger of its bytes over the memory rate
# and its operations over the peak rate of their type; "tf32x3" is a float32
# product in 3xTF32 (the "cluster_tf32" forms: three TF32 products on the
# tensor cores, 495 TFLOP/s, for each float32-accurate one)
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12,
            "tf32x3": 495e12 / 3}
HBM_BYTES_PER_S = 3.35e12
# joint training (phase 6): B7b and the m/l-saving K1 at the training shape
# against their plain versions (relative to max|ref|; bf16 as K1's serving
# check allows twice, the backward chaining three products), per-row cosine
B7B_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
B7B_COS = 0.9999
# the full-width step with flash-VJP against the plain attention path (same
# weights and batch, dropout 0): loss and each trainable leaf's gradient
STEP_LOSS_REL, STEP_GRAD_COS = 1e-2, 0.999
# the item step's forward gate (phase 7 (a), C-12).  The contrastive term is
# the hinge relu(margin + d(a, p) - d(a, n)), whose gradient jumps at 0, so
# the fused-anchor step runs on the plain-anchor step's active set (the
# reference decides which samples the hinge passes), and its forward is held
# to the reference's sample by sample: the anchor representation at the
# port's bf16 kernel class (max|d| / max|ref|, per-row cosine), and each
# hinge argument within what the representations' differences allow (d is
# 1-Lipschitz in either argument: |arg_f - arg_p| <= 2 |a_f - a_p| + |p_f -
# p_p| + |n_f - n_p|), plus both steps' rounding of the distances
ANCHOR_REP_REL, ANCHOR_REP_COS = 2e-2, 0.9999
TRAIN_BATCH, TRAIN_NEG, VAL_CANDIDATES = 8, 10, 100
TRAIN_ITEMS = 1500  # candidate items with 1024-d embeddings in the JSON
# item training (phase 7): batch 512 as the JAX package's scripts/bench_item.py,
# a 10-step trajectory, 256 users x 9 items (2,048 pairs: 4 steps an epoch)
# for the CLI, and a 2,000-item precompute
ITEM_BATCH, ITEM_STEPS, ITEM_CLI_USERS, PRECOMPUTE_ITEMS = 512, 10, 256, 2000
# user training (phase 8): UserQFormerConfig() at --max-seq-len 50, whose 64
# query tokens attend over 50 x 32 = 1,600 memory rows in 16 heads of 64; B13
# at the evaluation batch and B14 at the training batch (both 64), and both
# over a ragged 1,000-row memory, against their plain versions (KERNEL_TOL,
# KERNEL_COS)
USER_BATCH, USER_SEQ, USER_HEADS = 64, 50, 16
USER_RAGGED = (8, 1000)
# B13 / B14 also at the head dims of 32 and 8 heads of the same width, at
# hd 8 and 24 (zero-padded to 16 and 32; 24 in 16 heads, a width of 384) and
# at hd 256 (4 heads of the same width)
FLASH_OTHER_HD = (32, 128, 8, 24, 256)
# train_cli user-qformer: histories of 20-60 items over the sweep's cache
# (~760 sliding-window samples: 10 steps an epoch at batch 64, 2 evaluation
# batches), a few items missing from the cache
USER_CLI_USERS = 20
# (a) C-4/C-5: head dims above 256 (the chunked form); C-19: bf16 at every
# chunk count: K1 / B7b at hd 768 (three chunks), B13 / B14 / B14p at one
# head of 1024 (four) and B13 at one head of 1536 (six), the backward over
# rows at 768 and 1024 and B13 at 1536 in the cluster form; bf16 at 9
# chunks (hd 2304, above the cluster form's 8) in the scalar form
WIDE_HDS = (320, 512)
WIDE_BF16_HD, WIDE_ONE_HEAD_HD, WIDE_B13_HD = 768, 1024, 1536
WIDE_SCALAR_HD = 2304
WIDE_CAUSAL = dict(B=2, L=512, HQ=4, HKV=2, LENGTHS=(512, 301))
WIDE_CROSS = dict(B=8, LKV=1600, H=2, HD=512)
# fp32 at every chunk count of the 3xTF32 cluster form above WIDE_HDS' two
# (1400 ends inside its last chunk) and at 9 chunks (the scalar form), at
# small shapes; B13 / B14 timed at WIDE_CROSS's users and memory in one head
# of each of WIDE_FP32_TIMED
WIDE_FP32_HDS = (768, 1024, 1280, 1400, 1536, 1792, 2048, 2304)
WIDE_FP32_TIMED = (1024, 1536, 2048)
# (c) the Q-Former's LM head: QFormerConfig(), 32 query tokens over ViT-L/14's
# 257 patch tokens, 32 generated tokens
LM_BATCH, LM_MEMORY, LM_TOKENS = 64, 257, 32
# fp32 rounding near-ties of the two decoders: a top-2 logit gap below
# LM_TIE (the logits' scale is about 0.6 at these weights), in at most
# LM_TIE_ROWS of the 64 rows
LM_TIE, LM_TIE_ROWS = 1e-4, 2
# the user step's leaves below 1e-4 of the largest float32 leaf norm (phase
# 8 prints them: the first cross layer's query and key weights, the top self
# layer's) are sums of nearly cancelling terms, where the two bf16 steps
# differ mostly by rounding.  Their bf16 norms must stay below twice the
# threshold, and each (but the key biases, whose float32 gradient is noise
# too) must be as close to the float32 step in the --flash --fused step as in
# the plain one: 1 - cosine at most NOISE_GAP_RATIO times the plain step's
NOISE_LEAF, NOISE_GAP_RATIO = 1e-4, 2.0


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, ops: float, kind: str):
    """(bound_ms, bound_by): the least time the card could take for work
    that moves ``nbytes`` and does ``ops`` operations of type ``kind``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def causal_pairs(mask: torch.Tensor) -> int:
    """(query, key) pairs a causal attention over right-padded rows needs:
    row i of a batch row of length n attends min(i + 1, n) keys."""
    lengths = mask.sum(1).long()
    rows = torch.arange(1, mask.shape[1] + 1, device=mask.device)
    return int(torch.minimum(rows[None], lengths[:, None]).sum())


def k1_bytes(q, k, v, mask) -> float:
    """Bytes K1 must move: q read and o written in full, K and V read at the
    valid keys only (no query attends a padded key), the float32 mask."""
    valid = float(mask.sum()) / mask.numel()
    return (q.element_size() * (2 * q.numel() + (k.numel() + v.numel())
                                * valid) + 4 * mask.numel())


def sdpa_inputs(q, k, v, mask, hq, hkv):
    """The same attention laid out for scaled_dot_product_attention: per-head
    [B, H, L, hd] tensors, K/V repeated over the GQA group, and one boolean
    mask (causal and key-valid).  Made outside the timed call."""
    b, l, dq = q.shape
    hd = dq // hq
    qh = q.reshape(b, l, hq, hd).transpose(1, 2)
    kh, vh = (t.reshape(b, l, hkv, hd).repeat_interleave(hq // hkv, dim=2)
              .transpose(1, 2) for t in (k, v))
    causal = torch.ones(l, l, dtype=torch.bool, device=q.device).tril()
    allowed = causal[None, None] & (mask[:, None, None, :] != 0)
    return qh, kh, vh, allowed


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


def causal_inputs(gen, b, l, hq, hkv, hd, dtype, lengths):
    """q, k, v, dO (randn, cast to dtype) and the right-padded [B, L] mask."""
    mask = (torch.arange(l, device="cuda")[None]
            < torch.as_tensor(lengths, device="cuda")[:, None]).float()
    q, k, v, do = (torch.randn(b, l, h * hd, device="cuda", generator=gen)
                   .to(dtype) for h in (hq, hkv, hkv, hq))
    return q, k, v, do, mask


def check_repeat(name: str, first, again) -> None:
    """The kernels have one owner per output: a repeat gives the same bits."""
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        raise AssertionError(f"{name}: a repeat gave other bits")


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
    sdpa = torch.nn.functional.scaled_dot_product_attention
    pairs = causal_pairs(mask)
    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(b, l, hq * hd, device="cuda", generator=gen).to(dtype)
        k = torch.randn(b, l, hkv * hd, device="cuda", generator=gen).to(dtype)
        v = torch.randn(b, l, hkv * hd, device="cuda", generator=gen).to(dtype)
        check_k1(*k1_error(q, k, v, mask, hq, hkv), dtype, "phase 3")
        check_repeat(f"K1 {dtype}",
                     [flash_causal_attention(q, k, v, mask, hq, hkv)],
                     [flash_causal_attention(q, k, v, mask, hq, hkv)])

        # the kernel as the model calls it: the pad mask checked once per
        # forward, not once per launch (the unchecked call's host
        # synchronisation is timed apart)
        def kernel():
            return flash_causal_attention(q, k, v, mask, hq, hkv,
                                          mask_checked=True)

        kern = time_ms(kernel)
        plain = time_ms(
            lambda: flash_causal_attention_plain(q, k, v, mask, hq, hkv))
        kern2 = time_ms(kernel)
        checked = time_ms(
            lambda: flash_causal_attention(q, k, v, mask, hq, hkv))
        qh, kh, vh, allowed = sdpa_inputs(q, k, v, mask, hq, hkv)
        lib = time_ms(lambda: sdpa(qh, kh, vh, attn_mask=allowed))
        b_ms, b_by = bound(
            k1_bytes(q, k, v, mask), 2 * 2 * hd * pairs * hq,
            "bf16" if dtype == torch.bfloat16 else "fp32")
        times[dtype] = dict(ms=min(kern, kern2), plain_ms=plain, library_ms=lib,
                            bound_ms=b_ms, bound_by=b_by)
        log(f"K1 time {dtype} B={b} L={l} Hq={hq} Hkv={hkv} hd={hd}: kernel "
            f"{kern:.4f} / {kern2:.4f} ms (with the per-call pad-mask check "
            f"and its host synchronisation {checked:.4f} ms), plain "
            f"{plain:.4f} ms, scaled_dot_product_attention {lib:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
    return times


def sweep_block_bounds(n: int, elem: int, kind: str) -> dict:
    """bound_ms and bound_by of B1-B3 (``kind`` "bf16" or "fp32": b1-b3)
    or B4-B6 ("int8": b4-b6) at ``n`` items of the production widths:
    activations (x, mem, out) of ``elem`` bytes in and out once, weights
    once (``elem`` bytes, or int8 codes plus float32 column scales), float32
    vectors; the projections and attention products at ``kind``'s rate."""
    d, k, f, inter = QF_D, QF_K, QF_F, QF_INTER
    act = elem * 2 * n * k * d
    names = ("b4", "b5", "b6") if kind == "int8" else ("b1", "b2", "b3")
    wb = 1 if kind == "int8" else elem
    sc = 4 if kind == "int8" else 0  # a float32 scale per output column
    self_w, cross_w, ffn_w = 4 * d * d, 4 * d * d, 2 * d * inter
    return {
        names[0]: bound(
            act + self_w * wb + 6 * d * 4 + 4 * d * sc,
            n * (2 * k * d * 3 * d + 2 * 2 * k * k * d + 2 * k * d * d), kind),
        names[1]: bound(
            act + n * f * d * elem + n * f * 4 + cross_w * wb + 6 * d * 4
            + 4 * d * sc,
            n * (2 * k * d * d + 2 * f * d * 2 * d + 2 * 2 * k * f * d
                 + 2 * k * d * d), kind),
        names[2]: bound(
            act + ffn_w * wb + (inter + 3 * d) * 4 + (inter + d) * sc,
            n * 2 * 2 * k * d * inter, kind),
    }


def static_bounds() -> dict:
    """bound_ms and bound_by of the kernels whose work depends on the shapes
    alone, at the shapes their "ms" is timed at: B1-B6 (4096 items), B8 (the
    first serving projection), B9a and B9b (K2 and B11: retrieval_bound).
    Activations in and out once, weights once (bf16, or int8 codes plus
    float32 column scales), float32 vectors."""
    out = {**sweep_block_bounds(BLOCK_ITEMS[0], 2, "bf16"),
           **sweep_block_bounds(BLOCK_ITEMS[0], 2, "int8")}

    def linear(m, kk, nn):
        return bound(2 * m * kk + nn * kk + 4 * nn + 2 * m * nn,
                     2 * m * kk * nn, "int8")

    out["b8"] = linear(*B8_SHAPES[0])
    out["b9a"] = linear(B9_ROWS, QW_D, QW_QKV)
    out["b9b"] = bound(2 * 2 * B9_ROWS * QW_D + 3 * QW_I * QW_D
                       + 4 * (2 * QW_I + QW_D),
                       2 * B9_ROWS * QW_D * 3 * QW_I, "int8")
    return out


# -- K2 and B11 --------------------------------------------------------------


def retrieval_check(kind, users, catalog, k, scales=None, where="") -> float:
    """K2 (``scales`` None) or B11 against its plain version on the same
    inputs: one launch-counter increment a call, identical bits on a repeat,
    scores within K2_SCORE_TOL, ids equal but for near-ties (the plain
    scores of the two picks within K2_TIE), equal scores in ascending index
    order.  Returns the max score difference."""
    from unirec_tpu_torch.ops.losses import l2_normalize
    from unirec_tpu_torch.ops.quantization import (
        quantized_scores,
        quantized_top_k,
        retrieve_top_k_int8,
    )
    from unirec_tpu_torch.ops.ranking import retrieve_top_k, top_k_items

    if scales is None:
        wrapper = retrieve_top_k

        def call():
            return retrieve_top_k(users, catalog, k=k)
        ref = top_k_items(users, catalog, k=k)
        full = l2_normalize(users.float()) @ l2_normalize(catalog.float()).T
    else:
        wrapper = retrieve_top_k_int8

        def call():
            return retrieve_top_k_int8(users, catalog, scales, k=k)
        ref = quantized_top_k(users, catalog, scales, k=k)
        full = quantized_scores(users, catalog, scales)
    before = wrapper.launches
    s, i = call()
    torch.cuda.synchronize()
    if wrapper.launches != before + 1:
        raise AssertionError(f"{kind}: {wrapper.launches - before} counted "
                             f"launches for one call")
    again = call()
    if not (torch.equal(s, again[0]) and torch.equal(i, again[1])):
        raise AssertionError(f"{kind}{where}: a repeat gave other bits")
    s_ref, i_ref = ref
    score_err = (s - s_ref).abs().max().item()
    if not score_err <= K2_SCORE_TOL:
        raise AssertionError(f"{kind}{where}: scores differ by {score_err}")
    diff = i != i_ref
    if diff.any():  # only near-ties may swap: the kernel's pick must score
        gap = (full.gather(1, i) - s_ref)[diff].abs().max().item()
        if not gap < K2_TIE:  # within K2_TIE of the rank's true score
            raise AssertionError(f"{kind}{where}: ids differ beyond "
                                 f"near-ties ({gap})")
    if bool(((s[:, 1:] == s[:, :-1]) & (i[:, 1:] < i[:, :-1])).any()):
        raise AssertionError(f"{kind}{where}: a tie went to the higher index")
    log(f"{kind} users={users.shape[0]} N={catalog.shape[0]} "
        f"D={catalog.shape[1]} k={k}{where}: max|d score| {score_err:.3e}, "
        f"id mismatches {int(diff.sum())} (near-ties only), repeat identical")
    return score_err


def k2_compare(users, catalog, k):
    """K2 vs plain retrieval; returns the max score difference."""
    return retrieval_check("K2", users, catalog, k)


def retrieval_device_ms(call, iters: int, flush=None):
    """Device ms a call of K2 or B11 (``call``) from torch.profiler: each of
    its two kernels' own device time averaged over its recorded launches in
    ``iters`` calls, each call after ``flush`` (a CUDA buffer) is written and
    read when given.  Fails unless both kernels ran and, unflushed, nothing
    else did."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if flush is not None:
                flush.fill_(1.0)
                flush.sum()
            call()
        torch.cuda.synchronize()
    total, count, other = {}, {}, []
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0)
        name = next((n for n in RETRIEVAL_KERNELS if n in ev.key), None)
        if name:
            total[name] = total.get(name, 0.0) + t / 1e3
            count[name] = count.get(name, 0) + ev.count
        elif flush is None and t > 0:
            other.append(ev.key)
    if other or set(total) != set(RETRIEVAL_KERNELS):
        raise AssertionError(f"a retrieval call launched {sorted(total)} "
                             f"and {other}")
    split = {name: total[name] / count[name] for name in total}
    return sum(split.values()), split


def retrieval_bound(users: int, elem_bytes: int, n=CATALOG, d=DIM, k=K2_K):
    """(bound_ms, bound_by) of K2 (elem_bytes 4) or B11 (1): the catalog
    (and B11's row scales), the users and the [users, k] outputs once; the
    fp32 products."""
    scales = 4 * n if elem_bytes == 1 else 0
    return bound(elem_bytes * n * d + scales + 4 * users * d + 12 * users * k,
                 2 * users * n * d, "fp32")


def retrieval_times(kind, users, elem_bytes, call, plain, mm_topk, flush):
    """Cold and warm device ms a call, the plain version's and the context
    product + top-k's ms (CUDA events), and the bound."""
    cold, split = retrieval_device_ms(call, 20, flush)
    warm, _ = retrieval_device_ms(call, 20)
    cold2, _ = retrieval_device_ms(call, 20, flush)
    plain_ms, lib = time_ms(plain), time_ms(mm_topk)
    b_ms, b_by = retrieval_bound(users, elem_bytes)
    log(f"{kind} time users={users}: device ms a call, L2 flushed "
        f"{cold:.4f} / {cold2:.4f} (" + ", ".join(
            f"{n} {ms:.4f}" for n, ms in split.items()) + f"), warm "
        f"{warm:.4f}; plain {plain_ms:.4f} ms; torch.mm + torch.topk on "
        f"pre-normalised inputs {lib:.4f} ms (context); bound {b_ms:.4f} ms "
        f"({b_by})")
    return dict(ms=min(cold, cold2), warm_ms=warm, plain_ms=plain_ms,
                mm_topk_ms=lib, bound_ms=b_ms, bound_by=b_by)


def phase_k2(gen) -> dict:
    from unirec_tpu_torch.ops.losses import l2_normalize
    from unirec_tpu_torch.ops.ranking import retrieve_top_k, top_k_items

    catalog = torch.randn(CATALOG, DIM, device="cuda", generator=gen)
    cat_n = l2_normalize(catalog)
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    times = {}
    for n_users in K2_USERS:
        users = torch.randn(n_users, DIM, device="cuda", generator=gen)
        k2_compare(users, catalog, K2_K)
        u_n = l2_normalize(users)
        times[n_users] = retrieval_times(
            "K2", n_users, 4, lambda: retrieve_top_k(users, catalog, k=K2_K),
            lambda: top_k_items(users, catalog, k=K2_K),
            lambda: torch.topk(u_n @ cat_n.T, K2_K), flush)
        log_split(f"K2 users={n_users}",
                  lambda: retrieve_top_k(users, catalog, k=K2_K))
    return times


def edge_catalog(gen, n: int, d: int, negative_for=None):
    """A catalog with a zero row and a run of three equal rows across every
    share boundary of the card's plan; with ``negative_for`` (a user row)
    rows scoring negative against it."""
    from unirec_tpu_torch.ops.ranking import retrieval_plan, sm_count

    c = torch.randn(n, d, device="cuda", generator=gen)
    if negative_for is not None:
        c = (-torch.rand(n, 1, device="cuda", generator=gen) - 0.1) \
            * negative_for[None] + 0.3 * c
    c[min(5, n - 1)] = 0.0
    plan = retrieval_plan(1, n, d, 4, sm_count(c.device))
    for s in range(1, plan.shares):
        edge = s * plan.rows_per_share
        c[edge - 1:edge + 2] = c[edge]
    return c, plan


def phase_retrieval_edges(gen) -> None:
    """K2 and B11 at RETRIEVAL_EDGES (C-13: widths off 4), with user 0 equal
    to the row at the first share boundary (ties across it), and the cold
    device ms at D 1021 beside D 1024's."""
    from unirec_tpu_torch.ops.quantization import (
        quantize_rows,
        retrieve_top_k_int8,
    )
    from unirec_tpu_torch.ops.ranking import retrieve_top_k

    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    for b, n, d, k in RETRIEVAL_EDGES:
        cases = [(None, "")]
        if (b, n, d) == (8, CATALOG, 1021):
            cases.append((torch.randn(d, device="cuda", generator=gen),
                          " all scores negative"))
        for base, where in cases:
            catalog, plan = edge_catalog(gen, n, d, base)
            users = torch.randn(b, d, device="cuda", generator=gen)
            if base is not None:
                users[:] = base
                users += 0.3 * torch.randn(b, d, device="cuda",
                                           generator=gen)
            users[0] = 2.0 * catalog[min(plan.rows_per_share, n - 1)]
            retrieval_check("K2", users, catalog, k, where=where)
            codes, scales = quantize_rows(catalog)
            retrieval_check("B11", users, codes, k, scales, where=where)
            if base is not None:
                picked = retrieve_top_k(users, catalog, k=k)[0]
                if not bool((picked[1:, 1:] < 0).all()):  # but the zero row
                    raise AssertionError("the negative case scored >= 0")
            if n == CATALOG and base is None:
                k2 = retrieval_device_ms(
                    lambda: retrieve_top_k(users, catalog, k=k), 10, flush)[0]
                b11 = retrieval_device_ms(
                    lambda: retrieve_top_k_int8(users, codes, scales, k=k),
                    10, flush)[0]
                log(f"K2 / B11 users={b} N={n} D={d} k={k}: device ms a "
                    f"call, L2 flushed, {k2:.4f} / {b11:.4f}")


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


def block_inputs(gen, items, dtype=torch.bfloat16):
    """Unit-scale activations in ``dtype`` (bf16, or float32 for the fp32
    forms), ~15% missing fields, >= 8 items with no field at all, and random
    weights of the blocks' layouts in ``dtype``."""
    act = dtype

    def rand(*shape, std=1.0, dtype=act):
        return (torch.randn(*shape, device="cuda", generator=gen) * std
                ).to(dtype)

    def vec(n, mean=0.0):
        return mean + rand(n, std=0.1, dtype=torch.float32)

    d, k, f, inter = QF_D, QF_K, QF_F, QF_INTER
    x = rand(items, k, d)
    mask = (torch.rand(items, f, device="cuda", generator=gen) > 0.15).float()
    mask[:: max(items // 8, 1)][:8] = 0.0
    mem = rand(items, f, d) * mask[..., None].to(act)
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
                log_split(f"{name.upper()} {items} items", runs[name][0])
            library = {}
            if precision == "bf16":
                for name in names:
                    check_repeat(f"{name.upper()} {items} items",
                                 (runs[name][0](),), (runs[name][0](),))
                library = block_products_ms(x, mem, sw, cw, fw)
            for name in names:
                kern, plain = runs[name]
                t_k = time_ms(kern, iters=10, warmup=2)
                t_p = time_ms(plain, iters=5, warmup=1)
                t_k2 = time_ms(kern, iters=10, warmup=2)
                result[name].update(ms=min(t_k, t_k2), plain_ms=t_p,
                                    library_ms=library.get(name))
                log(f"{name.upper()} time {items} items: kernel {t_k:.4f} / "
                    f"{t_k2:.4f} ms, plain {t_p:.4f} ms"
                    + (f", cuBLAS for its products alone {library[name]:.4f}"
                       " ms" if name in library else ""))
        del x, mem, key_bias, runs, shapes
        torch.cuda.empty_cache()
    return result


def block_products_ms(x, mem, sw, cw, fw) -> dict:
    """The yardstick of B1-B3: ``torch.matmul`` (cuBLAS) time of each
    block's products alone, bf16 in and out, on tensors of their shapes (no
    bias, attention, residual or LayerNorm: no single PyTorch call computes
    the block)."""
    x2, mem2 = x.reshape(-1, x.shape[-1]), mem.reshape(-1, mem.shape[-1])
    h = x2.repeat(1, fw["w1"].shape[0] // x2.shape[1])  # [rows, inter]
    products = {
        "b1": ((x2, sw["wqkv"]), (x2, sw["wo"])),
        "b2": ((x2, cw["wq"]), (mem2, cw["wkv"]), (x2, cw["wo"])),
        "b3": ((x2, fw["w1"]), (h, fw["w2"]))}
    out = {}
    for name, pairs in products.items():
        out[name] = time_ms(lambda: [torch.matmul(a, w.t()) for a, w in pairs],
                            iters=10, warmup=2)
    return out


def phase_ln_routes(gen) -> None:
    """B1-B3's residual product and LayerNorm on each route their shape
    takes: the WG_BIAS_RESID_LN cluster epilogue against the two passes
    (WG_BIAS_RESID into fp32, then layer_norm_kernel) through the test entry
    ``unirec_gemm_ln_test`` at the sweep's two residual products (4096
    items) and at widths of 896 (the last of 4 CTAs 128 columns wide) and
    1032 (5 CTAs), within bf16 rounding, repeated for identical bits and
    timed; then B1-B3 against their plain versions at 4096 items of hidden
    896 (14 heads; the cluster with a ragged last tile) and 2304 (18 heads;
    two passes: more than a portable cluster of 8 CTAs), repeated for
    identical bits."""
    from unirec_tpu_torch.ops import fused_qformer_layer as fq
    from unirec_tpu_torch.ops._build import check, load_kernels

    lib = load_kernels().lib
    stream = torch.cuda.current_stream().cuda_stream

    def rand(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, device="cuda", generator=gen) * std
                ).to(dtype)

    def vec(n, mean=0.0):
        return mean + rand(n, std=0.1, dtype=torch.float32)

    rows = 32 * BLOCK_ITEMS[0]
    for m, n, k in ((rows, QF_D, QF_D), (rows, QF_D, QF_INTER),
                    (32 * BLOCK_ITEMS[1], 896, QF_D), (4000, 1032, 1032)):
        a, w = rand(m, k), rand(n, k, std=k ** -0.5)
        bias, resid, g, b = vec(n), rand(m, n), vec(n, 1.0), vec(n)
        acc = torch.empty(m, n, device="cuda")
        outs = [torch.empty(m, n, device="cuda", dtype=torch.bfloat16)
                for _ in range(2)]

        def run(which):
            check(lib.unirec_gemm_ln_test(
                which, a.data_ptr(), w.data_ptr(), bias.data_ptr(),
                resid.data_ptr(), g.data_ptr(), b.data_ptr(),
                outs[which].data_ptr(), acc.data_ptr() if which == 0 else None,
                m, n, k, 1e-12, stream), "unirec_gemm_ln_test")

        run(0)
        run(1)
        torch.cuda.synchronize()
        x0, x1 = outs[0].float(), outs[1].float()
        ulp = torch.exp2(torch.floor(torch.log2(x0.abs().clamp_min(1e-30)))
                         - 7)
        worst = ((x1 - x0).abs() - ulp).max().item()
        where = f"[{m}, {k}] x [{n}, {k}]"
        if not worst <= 1e-5:
            raise AssertionError(f"cluster LayerNorm {where}: beyond bf16 "
                                 f"rounding of the two passes ({worst:.3e})")
        first = outs[1].clone()
        run(1)
        check_repeat(f"cluster LayerNorm {where}", (first,), (outs[1],))
        t_two, t_one = (time_ms(lambda i=i: run(i), iters=10, warmup=2)
                        for i in (0, 1))
        log(f"residual GEMM + LayerNorm {where}: cluster of "
            f"{-(-n // 256)} CTAs within bf16 rounding of the two passes "
            f"(max excess over one ulp {worst:.2e}), repeats bit for bit; "
            f"two passes {t_two:.4f} ms, cluster {t_one:.4f} ms")
        del a, w, bias, resid, g, b, acc, outs
    for d, heads in ((896, 14), (2304, 18)):
        items = BLOCK_ITEMS[0]
        x = rand(items, QF_K, d)
        mask = (torch.rand(items, QF_F, device="cuda", generator=gen) > 0.15
                ).float()
        mask[::8] = 0.0
        mem = rand(items, QF_F, d) * mask[..., None].bfloat16()
        key_bias = ((1.0 - mask) * -1e9).contiguous()
        sw = dict(wqkv=rand(3 * d, d, std=0.03), bqkv=vec(3 * d),
                  wo=rand(d, d, std=0.03), bo=vec(d), ln_gamma=vec(d, 1.0),
                  ln_beta=vec(d))
        cw = dict(wq=rand(d, d, std=0.03), bq=vec(d),
                  wkv=rand(2 * d, d, std=0.03), bkv=vec(2 * d),
                  wo=rand(d, d, std=0.03), bo=vec(d), ln_gamma=vec(d, 1.0),
                  ln_beta=vec(d))
        fw = dict(w1=rand(QF_INTER, d, std=0.03), b1=vec(QF_INTER),
                  w2=rand(d, QF_INTER, std=0.02), b2=vec(d),
                  ln_gamma=vec(d, 1.0), ln_beta=vec(d))
        sk = dict(num_heads=heads, n_q=QF_K)
        route = ("two passes" if fq.two_pass_layer_norm(d, d)
                 else f"a cluster of {-(-d // 256)} CTAs")
        where = f"hidden {d}, {heads} heads, {items} items ({route})"
        for name, fn, args, w, kw in (
                ("b1", "fused_self_attention_block", (x,), sw, sk),
                ("b2", "fused_cross_attention_block", (x, mem, key_bias), cw,
                 dict(sk, n_kv=QF_F)),
                ("b3", "fused_ffn_block", (x,), fw, {})):
            kern, plain = getattr(fq, fn), getattr(fq, fn + "_plain")
            out = kern(*args, **w, **kw)
            torch.cuda.synchronize()
            err, cos = block_error(out, plain(*args, **w, **kw))
            check_block(name.upper(), err, cos, where)
            check_repeat(f"{name.upper()} {where}", (out,),
                         (kern(*args, **w, **kw),))
            log(f"{name.upper()} time {where}: kernel "
                f"{time_ms(lambda: kern(*args, **w, **kw), iters=5, warmup=1):.4f} ms")
        del x, mem, key_bias, sw, cw, fw
    torch.cuda.empty_cache()


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
    for heads, f in WIDE_BLOCKS:  # C-6 and C-9
        items = WIDE_K_ITEMS
        x = torch.randn(items, QF_K, QF_D, device="cuda", generator=gen
                        ).bfloat16()
        mask = (torch.rand(items, f, device="cuda", generator=gen) > 0.15
                ).float()
        mask[::8] = 0.0
        mem = (torch.randn(items, f, QF_D, device="cuda", generator=gen)
               * mask[..., None]).bfloat16()
        key_bias = ((1.0 - mask) * -1e9).contiguous()
        sk = dict(num_heads=heads, n_q=QF_K)
        ck = dict(sk, n_kv=f)
        where = f"{heads} heads of {QF_D // heads}, F={f}, {items} items"
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
            check_block(name.upper(), err, cos, where)
            errs[name] = max(errs[name], err)
            check_repeat(f"{name.upper()} {where}", (out,), (kern(),))
            log(f"{name.upper()} time {where}: kernel "
                f"{time_ms(kern, iters=10, warmup=2):.4f} ms")
    return errs


# the int8 epilogues of gemm_wide.cuh by the test entry unirec_gemm_q_test's
# index: EPQ_BIAS, EPQ_BIAS_F32, EPQ_BIAS_RESID, EPQ_CHUNKED_RESID,
# EPQ_PLAIN, EPQ_SWIGLU
GEMM_Q_EPIS = ("bias", "bias_f32", "bias_resid", "chunked_resid", "plain",
               "swiglu", "chunked")


def gemm_q_plain(epi: str, a, w, rs, cs, bias, resid, chunk: int,
                 exp=torch.exp):
    """The plain form of one ``unirec_gemm_q_test`` call: the exact int32
    product (``_mm_q``'s float64 sum), then the epilogue's fp32 roundings in
    its order.  rs [m, groups]; w [2n, k] for ``swiglu``, which returns (h,
    each row's max |h|) with sigmoid(g) = 1 / (1 + exp(-g)) divided as one
    IEEE division (``exp``: the device's expf on the card is torch.exp's)."""
    from unirec_tpu_torch.ops.fused_qformer_int8 import _int_mm, true_div

    if epi in ("chunked_resid", "chunked"):
        f = torch.zeros(a.shape[0], w.shape[0], device=a.device)
        for g in range(a.shape[1] // chunk):
            c = slice(g * chunk, (g + 1) * chunk)
            f = f + _int_mm(a[:, c], w[:, c]) * rs[:, g:g + 1]
        return f * cs + bias + (resid.float() if epi == "chunked_resid" else 0.0)
    f = _int_mm(a, w) * rs[:, :1] * cs
    if epi == "swiglu":
        g, u = f.chunk(2, dim=1)
        h = (g * true_div(1.0, 1.0 + exp(-g))) * u
        return h, h.abs().amax(dim=1)
    if epi in ("bias", "plain"):
        return (f + bias if epi == "bias" else f).bfloat16()
    return f + bias + (resid.float() if epi == "bias_resid" else 0.0)


def phase_int8_gemm(gen) -> None:
    """The int8 TMA + wgmma GEMM that B4-B6, B8, B9a and B9b run on, in each
    of its epilogues, against its plain form (``gemm_q_plain``) through the
    test entry ``unirec_gemm_q_test``, ``torch.equal``: B6's two products,
    B4's QKV product and a ragged row count, B6's down projection over one
    and four chunks, and the Qwen3 serving products (B9a, B9b's gate|up with
    h's row maxima and its down projection, at 4096 and a ragged 1,000
    rows); each repeated for identical bits and timed at 4096 items
    (131,072 rows) and 4096 Qwen3 rows."""
    from unirec_tpu_torch.ops._build import check, load_kernels

    lib = load_kernels().lib
    d, inter = QF_D, QF_INTER
    # (rows, n, k, epilogue, chunk); swiglu: n columns of h, w [2n, k]
    cases = [(32 * BLOCK_ITEMS[1], 3 * d, d, "bias", d),
             (32 * BLOCK_ITEMS[1], inter, d, "bias_f32", d),
             (32 * BLOCK_ITEMS[1], d, d, "bias_resid", d),
             (32 * BLOCK_ITEMS[1], d, inter, "chunked_resid", inter),
             (32 * BLOCK_ITEMS[1], d, inter, "chunked_resid", 1024),
             (32 * BLOCK_ITEMS[0], inter, d, "bias_f32", d),
             (32 * BLOCK_ITEMS[0], d, inter, "chunked_resid", inter),
             (B9_ROWS, QW_QKV, QW_D, "plain", QW_D),
             (B9_ROWS, QW_I, QW_D, "swiglu", QW_D),
             (B9_ROWS, QW_D, QW_I, "plain", QW_I),
             (1000, QW_I, QW_D, "swiglu", QW_D),
             (1000, 2 * QW_D, QW_D, "plain", QW_D)]
    for m, n, k, epi, chunk in cases:
        wn = 2 * n if epi == "swiglu" else n
        a = torch.randint(-127, 128, (m, k), device="cuda", generator=gen,
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (wn, k), device="cuda", generator=gen,
                          dtype=torch.int8)
        groups = k // chunk if epi.startswith("chunked") else 1
        rs = torch.rand(m, groups, device="cuda", generator=gen) * 1e-3
        cs = torch.rand(wn, device="cuda", generator=gen) * 1e-2
        bias = torch.randn(n, device="cuda", generator=gen) * 0.1
        resid = torch.randn(m, n, device="cuda", generator=gen).bfloat16()
        dtype = torch.bfloat16 if epi in ("bias", "plain") else torch.float32
        outs = [torch.empty(m, n, device="cuda", dtype=dtype) for _ in range(2)]
        maxes = [torch.zeros(m, device="cuda") for _ in range(2)]

        def run(i):
            if epi == "swiglu":  # the row maxima start at 0
                maxes[i].zero_()
            err = lib.unirec_gemm_q_test(
                GEMM_Q_EPIS.index(epi), a.data_ptr(), w.data_ptr(),
                rs.data_ptr(), groups, cs.data_ptr(), bias.data_ptr(),
                resid.data_ptr(), outs[i].data_ptr(), maxes[i].data_ptr(), m,
                n, k, chunk, torch.cuda.current_stream().cuda_stream)
            check(err, "unirec_gemm_q_test")

        run(0)
        run(1)
        ref = gemm_q_plain(epi, a, w, rs, cs, bias, resid, chunk)
        torch.cuda.synchronize()
        where = f"{epi} [{m}, {k}] x [{wn}, {k}], chunk {chunk}"
        ok = torch.equal(outs[0], ref[0] if epi == "swiglu" else ref)
        if epi == "swiglu":  # the row maxima of the kernel's own h, and h
            ok = ok and torch.equal(maxes[0], ref[1])
        if not ok:
            raise AssertionError(f"int8 TMA GEMM {where}: not its plain "
                                 "form's bits")
        if not (torch.equal(outs[0], outs[1])
                and torch.equal(maxes[0], maxes[1])):
            raise AssertionError(f"int8 TMA GEMM {where}: a repeat gave other "
                                 "bits")
        msg = (f"int8 TMA GEMM {where}: its plain form's bits"
               f"{' (h and its row maxima)' if epi == 'swiglu' else ''}, "
               "repeats bit for bit")
        if m in (32 * BLOCK_ITEMS[0], B9_ROWS):
            t = time_ms(lambda: run(1), iters=10, warmup=2)
            ops = 2 * m * wn * k
            msg += f"; {t:.4f} ms ({ops / t / 1e9:.1f} TOP/s)"
        log(msg)
        del a, w, rs, cs, bias, resid, outs, maxes, ref
    torch.cuda.empty_cache()


def phase_widths(gen) -> None:
    """B1-B6 at hidden 1020 (not a multiple of 8 bf16 values: every product
    on gemm_wide.cuh's edge kernel, the two-pass LayerNorm) and 1032 (a
    multiple of 8 but not of 16 int8 codes: B1-B3 on the TMA kernel with the
    LayerNorm over a cluster of 5 CTAs, B4-B6 on the int8 edge kernel), 4
    heads, intermediate 4096,
    64 items with ~15% missing fields, against their plain versions at the
    blocks' gate, repeated for identical bits (C-10)."""
    from unirec_tpu_torch.ops import fused_qformer_int8 as pq
    from unirec_tpu_torch.ops import fused_qformer_layer as fq

    items, heads, k, f, inter = WIDE_K_ITEMS, 4, QF_K, QF_F, QF_INTER
    for d in (1020, 1032):
        def rand(*shape, std=1.0, dtype=torch.bfloat16):
            return (torch.randn(*shape, device="cuda", generator=gen) * std
                    ).to(dtype)

        def vec(n, mean=0.0):
            return mean + rand(n, std=0.1, dtype=torch.float32)

        x = rand(items, k, d)
        mask = (torch.rand(items, f, device="cuda", generator=gen) > 0.15
                ).float()
        mask[::8] = 0.0
        mem = rand(items, f, d) * mask[..., None].bfloat16()
        key_bias = ((1.0 - mask) * -1e9).contiguous()
        sw = dict(wqkv=rand(3 * d, d, std=0.03), bqkv=vec(3 * d),
                  wo=rand(d, d, std=0.03), bo=vec(d), ln_gamma=vec(d, 1.0),
                  ln_beta=vec(d))
        cw = dict(wq=rand(d, d, std=0.03), bq=vec(d),
                  wkv=rand(2 * d, d, std=0.03), bkv=vec(2 * d),
                  wo=rand(d, d, std=0.03), bo=vec(d), ln_gamma=vec(d, 1.0),
                  ln_beta=vec(d))
        fw = dict(w1=rand(inter, d, std=0.03), b1=vec(inter),
                  w2=rand(d, inter, std=0.02), b2=vec(d),
                  ln_gamma=vec(d, 1.0), ln_beta=vec(d))
        sk = dict(num_heads=heads, n_q=k)
        ck = dict(sk, n_kv=f)
        for mod, sfx, names, (s_w, c_w, f_w) in (
                (fq, "", ("b1", "b2", "b3"), (sw, cw, fw)),
                (pq, "_q", ("b4", "b5", "b6"),
                 (quantized(sw), quantized(cw), quantized(fw)))):
            runs = {
                names[0]: ("fused_self_attention_block", (x,), s_w, sk),
                names[1]: ("fused_cross_attention_block", (x, mem, key_bias),
                           c_w, ck),
                names[2]: ("fused_ffn_block", (x,), f_w, {})}
            for name, (fn, args, w, kw) in runs.items():
                kern = getattr(mod, fn + sfx)
                plain = getattr(mod, fn + sfx + "_plain")
                out = kern(*args, **w, **kw)
                torch.cuda.synchronize()
                where = f"hidden {d}, {heads} heads, {items} items"
                err, cos = block_error(out, plain(*args, **w, **kw))
                check_block(name.upper(), err, cos, where)
                check_repeat(f"{name.upper()} {where}", (out,),
                             (kern(*args, **w, **kw),))
                log(f"{name.upper()} time {where}: kernel "
                    f"{time_ms(lambda: kern(*args, **w, **kw), iters=5, warmup=1):.4f} ms")
        del x, mem, key_bias, sw, cw, fw
        torch.cuda.empty_cache()


def log_split(name: str, fn, iters: int = 5) -> None:
    """The device time of each launch inside one call of ``fn`` (a block's
    C entry makes several: GEMMs, attention, LayerNorm), from
    ``torch.profiler`` over ``iters`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = device_time_by_kernel(prof)

    def short(key: str) -> str:  # "void (anonymous namespace)::gemm<0>(..." -> gemm<0>
        key = key.replace("(anonymous namespace)::", "").removeprefix("void ")
        return key.split("(")[0].split("::")[-1][:48]

    log(f"{name} split, device ms a call: " + "; ".join(
        f"{ms / iters:.4f} {short(key)}" for key, ms in rows))


# -- B12s / B12c: the trainable fused blocks ---------------------------------


def kernel_error(name, out, ref, where, noise_rows=None,
                 noise_floor=0.0) -> float:
    """Checks a kernel's output against its plain version (the same dtype,
    compared in fp32): max|d| <= KERNEL_TOL * max|ref| and, in bf16, per-row
    cosine >= KERNEL_COS over the rows where ref is nonzero, except
    ``noise_rows``: the query rows of an item with no valid field, whose
    exact B12c dq is 0 (its keys are one and the same row, and ds sums to 0
    over them), so that both versions return rounding noise there, which the
    max|d| bound holds; and, with ``noise_floor``, the rows whose ref norm
    is below that share of the largest row's (logged: how many, the largest
    of them and the smallest row kept, relative to the top).  Returns
    max|d|."""
    a = out.float().reshape(-1, out.shape[-1])
    b = ref.float().reshape(-1, ref.shape[-1])
    if not bool(torch.isfinite(a).all()):
        raise AssertionError(f"{name} {where}: non-finite values")
    err = (a - b).abs().max().item()
    rel = err / b.abs().max().item()
    tol = KERNEL_TOL[out.dtype]
    msg = f"{name} {where}: max|d| {err:.3e}, rel {rel:.3e} (tol {tol:g})"
    ok = rel <= tol
    if out.dtype == torch.bfloat16:
        live = b.abs().amax(-1) > 0
        if noise_rows is not None:
            live &= ~noise_rows
        if noise_floor:
            ratio = b.norm(dim=-1) / b.norm(dim=-1).max()
            quiet = live & (ratio < noise_floor)
            live &= ~quiet
            msg += (f", {int(quiet.sum())} rows below {noise_floor:g} of the "
                    "top row's norm leave the cosine test"
                    + (f" (largest {ratio[quiet].max().item():.2e})"
                       if bool(quiet.any()) else "")
                    + f", smallest kept {ratio[live].min().item():.2e}")
        cos = torch.nn.functional.cosine_similarity(a[live], b[live], dim=-1)
        msg += (f", min row cosine {cos.min().item():.7f} over "
                f"{int(live.sum())} rows (tol {KERNEL_COS})")
        ok = ok and cos.min().item() >= KERNEL_COS
    log(msg)
    if not ok:
        raise AssertionError(f"{name} {where} disagrees with its plain version")
    return err


def b12_bounds(items: int, elem: int = 2, kind: str = "bf16") -> dict:
    """bound_ms and bound_by of the four B12 kernels at ``items`` items of
    the production widths: inputs read once and outputs written once
    (``elem`` bytes: bf16, or 4 for the fp32 forms; float32 key bias and
    biases; dctx is the kernels' own scratch), and the projection and
    per-item attention products (s and p.v forward; s, dp, dq, dk and dv
    backward) at ``kind``'s rate."""
    d, k, f, h = QF_D, QF_K, QF_F, QF_HEADS
    rows, mrows = items * k, items * f
    e = elem
    w = e * d * d  # one [d, d] weight
    attn = 2 * k * (d // h) * h  # one [k, n] x [n, hd] product per row pair
    return {
        "b12s_fwd": bound(e * rows * d + 4 * w + 4 * 4 * d + 4 * rows
                          + e * rows * (d + 3 * d + d),
                          2 * rows * d * 4 * d + 2 * attn * rows, kind),
        "b12s_bwd": bound(e * rows * 3 * d + w + 4 * rows + e * rows * d
                          + e * rows * 3 * d,
                          2 * rows * d * d + 5 * attn * rows, kind),
        "b12c_fwd": bound(e * rows * d + e * mrows * d + 4 * w + 4 * 4 * d
                          + 4 * mrows + e * rows * 3 * d + e * mrows * 2 * d,
                          2 * rows * d * 2 * d + 2 * mrows * d * 2 * d
                          + 2 * 2 * k * f * d * items, kind),
        "b12c_bwd": bound(e * rows * d + e * mrows * 2 * d + w + 4 * mrows
                          + e * rows * d + e * rows * d + e * mrows * 2 * d,
                          2 * rows * d * d + 5 * 2 * k * f * d * items,
                          kind),
    }


def b12_library_calls(x, mem, key_bias, sw, cw) -> dict:
    """The PyTorch yardstick of the two B12 forwards: one
    ``multi_head_attention_forward`` call computes their ``out`` (the input
    projections, attention under the per-key bias, the output projection)
    from the same weights, in the sequence-first layout made here, outside
    the timed call; it returns neither qkv nor ctx, which the kernels save.
    No single call computes the backwards."""
    mha = torch.nn.functional.multi_head_attention_forward
    d, h = QF_D, QF_HEADS
    xs = x.transpose(0, 1).contiguous()
    ms = mem.transpose(0, 1).contiguous()
    kpm = key_bias.to(x.dtype)
    bqkv = torch.cat([cw["bq"], cw["bkv"]]).to(x.dtype)
    return {
        "b12s_fwd": lambda: mha(
            xs, xs, xs, d, h, sw["wqkv"], sw["bqkv"].to(x.dtype), None, None,
            False, 0.0, sw["wo"], sw["bo"].to(x.dtype), training=False,
            need_weights=False)[0],
        "b12c_fwd": lambda: mha(
            xs, ms, ms, d, h, None, bqkv, None, None, False, 0.0, cw["wo"],
            cw["bo"].to(x.dtype), training=False, key_padding_mask=kpm,
            need_weights=False, use_separate_proj_weight=True,
            q_proj_weight=cw["wq"], k_proj_weight=cw["wkv"][:d],
            v_proj_weight=cw["wkv"][d:])[0],
    }


def phase_b12(gen) -> dict:
    """B12s and B12c, forward and backward, against their plain versions at
    the item-training shape (512 items and a ragged 509; ~15% missing fields,
    >= 8 items with none), each run twice for identical bits; timed with
    CUDA events at 512 items beside the plain versions and the bounds.  Then
    B12s at the user stage's shape (64 users of 64 query rows)."""
    from unirec_tpu_torch.ops import fused_qformer_vjp as fv

    d, k, f = QF_D, QF_K, QF_F
    skw = dict(num_heads=QF_HEADS, n_q=k)
    ckw = dict(skw, n_kv=f)
    names = ("b12s_fwd", "b12s_bwd", "b12c_fwd", "b12c_bwd")
    result = {n: {"err": 0.0} for n in names}
    for items in B12_ITEMS:
        x, mem, key_bias, mask, sw, cw, _ = block_inputs(gen, items)
        x2, mem2 = x.reshape(-1, d), mem.reshape(-1, d)
        kb = key_bias.reshape(-1).contiguous()
        zero = torch.zeros(x2.shape[0], device="cuda")  # queries: no mask
        dout = (torch.randn(x2.shape, device="cuda", generator=gen) * 0.1
                ).bfloat16()
        # the model hands the blocks its biases in the compute dtype
        sa = (x2, zero, sw["wqkv"], sw["bqkv"].bfloat16(), sw["wo"],
              sw["bo"].bfloat16())
        ca = (x2, mem2, kb, cw["wq"], cw["bq"].bfloat16(), cw["wkv"],
              cw["bkv"].bfloat16(), cw["wo"], cw["bo"].bfloat16())
        s_out = fv.self_attention_fwd(*sa, **skw)
        c_out = fv.cross_attention_fwd(*ca, **ckw)
        qkv, q, kv = s_out[1], c_out[1], c_out[2]
        runs = {
            "b12s_fwd": (lambda: fv.self_attention_fwd(*sa, **skw),
                         lambda: fv.self_attention_fwd_plain(*sa, **skw),
                         ("out", "qkv", "ctx")),
            "b12s_bwd": (lambda: fv.self_attention_bwd(qkv, sw["wo"], zero,
                                                       dout, **skw),
                         lambda: fv.self_attention_bwd_plain(
                             qkv, sw["wo"], zero, dout, **skw), ("dqkv",)),
            "b12c_fwd": (lambda: fv.cross_attention_fwd(*ca, **ckw),
                         lambda: fv.cross_attention_fwd_plain(*ca, **ckw),
                         ("out", "q", "kv", "ctx")),
            "b12c_bwd": (lambda: fv.cross_attention_bwd(q, kv, cw["wo"], kb,
                                                        dout, **ckw),
                         lambda: fv.cross_attention_bwd_plain(
                             q, kv, cw["wo"], kb, dout, **ckw), ("dq", "dkv")),
        }
        noise = (mask.sum(1) == 0).repeat_interleave(k)
        where = (f"{items} items, {int((mask.sum(1) == 0).sum())} without "
                 f"fields")
        for name, (kern, plain, outs) in runs.items():
            got = kern()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            ref = plain()
            ref = ref if isinstance(ref, tuple) else (ref,)
            for o, g, r in zip(outs, got, ref):
                err = kernel_error(f"{name.upper()} {o}", g, r, where,
                                noise if o == "dq" else None)
                result[name]["err"] = max(result[name]["err"], err)
            again = kern()
            again = again if isinstance(again, tuple) else (again,)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{name.upper()} {where}: a repeat gave "
                                     "other bits")
        log(f"B12 {where}: the four kernels repeat bit for bit")
        if items == B12_ITEMS[0]:
            bounds = b12_bounds(items)
            library = b12_library_calls(x, mem, key_bias, sw, cw)
            for name, call in library.items():  # the same function: out
                lib_out = call().transpose(0, 1).reshape(-1, d)
                kern_out = runs[name][0]()[0]
                cos = torch.nn.functional.cosine_similarity(
                    lib_out.float(), kern_out.float(), dim=-1).min().item()
                log(f"{name.upper()} out against multi_head_attention_forward"
                    f": min row cosine {cos:.6f} (tol 0.999)")
                if not cos >= 0.999:
                    raise AssertionError(f"{name.upper()}: the yardstick "
                                         "computes another function")
            for name, (kern, plain, _) in runs.items():
                log_split(f"{name.upper()} {items} items", kern)
                t_k = time_ms(kern, iters=20, warmup=3)
                t_p = time_ms(plain, iters=5, warmup=1)
                t_k2 = time_ms(kern, iters=20, warmup=3)
                t_l = (time_ms(library[name], iters=20, warmup=3)
                       if name in library else None)
                b_ms, b_by = bounds[name]
                result[name].update(ms=min(t_k, t_k2), plain_ms=t_p,
                                    bound_ms=b_ms, bound_by=b_by,
                                    library_ms=t_l)
                log(f"{name.upper()} time {items} items: kernel {t_k:.4f} / "
                    f"{t_k2:.4f} ms, plain {t_p:.4f} ms, bound {b_ms:.4f} ms "
                    f"({b_by}), " + (
                        f"multi_head_attention_forward {t_l:.4f} ms (out "
                        "only)" if t_l is not None
                        else "no single PyTorch call computes it"))
        del x, mem, runs, s_out, c_out, qkv, q, kv
        torch.cuda.empty_cache()
    # B12s at the user stage's shape: 64 users of 64 query rows
    d, n_q = QF_D, 64
    where = f"{USER_BATCH} users x {n_q} query rows"

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, device="cuda", generator=gen)
                * scale).bfloat16()

    x2, dout = rand(USER_BATCH * n_q, d), rand(USER_BATCH * n_q, d, scale=0.1)
    zero = torch.zeros(x2.shape[0], device="cuda")
    sa = (x2, zero, rand(3 * d, d, scale=0.03), rand(3 * d, scale=0.01),
          rand(d, d, scale=0.03), rand(d, scale=0.01))
    ukw = dict(num_heads=QF_HEADS, n_q=n_q)
    got = fv.self_attention_fwd(*sa, **ukw)
    torch.cuda.synchronize()
    for o, g, r in zip(("out", "qkv", "ctx"), got,
                       fv.self_attention_fwd_plain(*sa, **ukw)):
        err = kernel_error(f"B12S_FWD {o}", g, r, where)
        result["b12s_fwd"]["err"] = max(result["b12s_fwd"]["err"], err)
    args = (got[1], sa[4], zero, dout)
    err = kernel_error("B12S_BWD dqkv", fv.self_attention_bwd(*args, **ukw),
                    fv.self_attention_bwd_plain(*args, **ukw), where)
    result["b12s_bwd"]["err"] = max(result["b12s_bwd"]["err"], err)
    return result


def phase_b12_shapes(gen) -> dict:
    """B12s and B12c, forward and backward, at the B12_SHAPES that
    supports_fused_train admits and the old kernels refused (C-7, C-10),
    against their plain versions with the phase's gates, each repeated for
    identical bits and timed.  Returns max|d| per kernel."""
    from unirec_tpu_torch.ops import fused_qformer_vjp as fv

    errs = {n: 0.0 for n in ("b12s_fwd", "b12s_bwd", "b12c_fwd", "b12c_bwd")}
    for items, k, f, d, heads in B12_SHAPES:
        if not fv.supports_fused_train(k, d, heads, f):
            raise AssertionError(f"B12 {(k, f, d, heads)} is not admitted")
        where = (f"{items} items, K={k}, F={f}, D={d}, {heads} heads of "
                 f"{d // heads}")

        def rand(*shape, std=1.0):
            return (torch.randn(*shape, device="cuda", generator=gen) * std
                    ).bfloat16()

        mask = (torch.rand(items, f, device="cuda", generator=gen) > 0.15
                ).float()
        mask[::8] = 0.0
        x2, dout = rand(items * k, d), rand(items * k, d, std=0.1)
        mem2 = (rand(items, f, d) * mask[..., None].bfloat16()).reshape(-1, d)
        kb = ((1.0 - mask) * -1e9).reshape(-1).contiguous()
        zero = torch.zeros(items * k, device="cuda")
        s = d ** -0.5
        sa = (x2, zero, rand(3 * d, d, std=s), rand(3 * d, std=0.1),
              rand(d, d, std=s), rand(d, std=0.1))
        ca = (x2, mem2, kb, rand(d, d, std=s), rand(d, std=0.1),
              rand(2 * d, d, std=s), rand(2 * d, std=0.1), rand(d, d, std=s),
              rand(d, std=0.1))
        skw = dict(num_heads=heads, n_q=k)
        ckw = dict(skw, n_kv=f)
        qkv = fv.self_attention_fwd_plain(*sa, **skw)[1]
        _, q, kv, _ = fv.cross_attention_fwd_plain(*ca, **ckw)
        noise = (mask.sum(1) == 0).repeat_interleave(k)
        runs = {
            "b12s_fwd": (lambda: fv.self_attention_fwd(*sa, **skw),
                         lambda: fv.self_attention_fwd_plain(*sa, **skw),
                         ("out", "qkv", "ctx")),
            "b12s_bwd": (lambda: fv.self_attention_bwd(qkv, sa[4], zero, dout,
                                                       **skw),
                         lambda: fv.self_attention_bwd_plain(
                             qkv, sa[4], zero, dout, **skw), ("dqkv",)),
            "b12c_fwd": (lambda: fv.cross_attention_fwd(*ca, **ckw),
                         lambda: fv.cross_attention_fwd_plain(*ca, **ckw),
                         ("out", "q", "kv", "ctx")),
            "b12c_bwd": (lambda: fv.cross_attention_bwd(q, kv, ca[7], kb, dout,
                                                        **ckw),
                         lambda: fv.cross_attention_bwd_plain(
                             q, kv, ca[7], kb, dout, **ckw), ("dq", "dkv")),
        }
        for name, (kern, plain, outs) in runs.items():
            got = kern()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            ref = plain()
            ref = ref if isinstance(ref, tuple) else (ref,)
            for o, g, r in zip(outs, got, ref):
                err = kernel_error(f"{name.upper()} {o}", g, r, where,
                                   noise if o == "dq" else None)
                errs[name] = max(errs[name], err)
            again = kern()
            again = again if isinstance(again, tuple) else (again,)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{name.upper()} {where}: a repeat "
                                     "gave other bits")
            log(f"{name.upper()} time {where}: kernel "
                f"{time_ms(kern, iters=10, warmup=2):.4f} ms")
        del runs, qkv, q, kv
        torch.cuda.empty_cache()
    return errs


# -- B13 / B14: the user stage's streaming cross-attention --------------------


# -- the fp32 forms of B1-B6 and B12 ("fp32 fused") ---------------------------

# the blocks' and the engine's batch, B12's (the item-training shape), and
# the engine's gates: the fp32 engine against the plain fp32 ItemQFormer,
# the int8 engine at fp32 activations against it (the gate of
# scripts/measure_int8_quality.py); B1-B3 and B12 take KERNEL_TOL[float32]
FP32_ITEMS, FP32_B12_ITEMS = 1024, 512
FP32_ENGINE_REL, FP32_ENGINE_COS, FP32_INT8_COS = 1e-4, 0.99999, 0.999


def b6_codes(x, fw) -> torch.Tensor:
    """x's int8 codes as B6's kernel quantizes them: the C entry called with
    scratch made here (not the wrapper: no launch is counted), whose xq
    holds x's codes when it returns."""
    from unirec_tpu_torch.ops import fused_qformer_int8 as pq
    from unirec_tpu_torch.ops._build import check, load_kernels
    from unirec_tpu_torch.ops.attention import dtype_code

    rows, d = x.shape[0] * x.shape[1], x.shape[2]
    inter = fw["w1"].shape[0]
    chunk = pq.ffn_q_chunk(inter)

    def empty(*shape, dtype=torch.float32):
        return torch.empty(*shape, device=x.device, dtype=dtype)

    xq = empty(rows, d, dtype=torch.int8)
    scratch = [empty(rows), empty(rows, inter),
               empty(rows, inter, dtype=torch.int8),
               empty(rows, inter // chunk), empty(rows, d)]
    out = torch.empty_like(x)
    err = load_kernels().lib.unirec_qformer_ffn_block_q(
        x.data_ptr(), fw["w1"].data_ptr(), fw["s1"].data_ptr(),
        fw["b1"].data_ptr(), fw["w2"].data_ptr(), fw["s2"].data_ptr(),
        fw["b2"].data_ptr(), fw["ln_gamma"].data_ptr(),
        fw["ln_beta"].data_ptr(), out.data_ptr(), xq.data_ptr(),
        *(t.data_ptr() for t in scratch), rows, d, inter, chunk,
        dtype_code(x), 1e-12, torch.cuda.current_stream().cuda_stream)
    check(err, "unirec_qformer_ffn_block_q")
    torch.cuda.synchronize()
    return xq


def fp32_blocks(gen) -> dict:
    """B1-B3 at float32 and B4-B6 at float32 activations, production widths,
    FP32_ITEMS items: each against its plain version (B1-B3 max|d| /
    max|ref| <= 1e-5; B4-B6 the int8 blocks' gate), repeated for identical
    bits with exact launch counts, x's int8 codes in B6 those of the plain
    row_quant of the fp32 x bit for bit; timed beside the plain versions,
    the bounds and, for B1-B3, cuBLAS fp32 for the products alone."""
    from unirec_tpu_torch.ops import fused_qformer_int8 as pq
    from unirec_tpu_torch.ops import fused_qformer_layer as fq

    n = FP32_ITEMS
    x, mem, key_bias, mask, sw, cw, fw = block_inputs(gen, n, torch.float32)
    qsw, qcw, qfw = quantized(sw), quantized(cw), quantized(fw)
    sk = dict(num_heads=QF_HEADS, n_q=QF_K)
    ck = dict(sk, n_kv=QF_F)
    blocks = {
        "b1": (fq.fused_self_attention_block,
               fq.fused_self_attention_block_plain, (x,), sw, sk),
        "b2": (fq.fused_cross_attention_block,
               fq.fused_cross_attention_block_plain, (x, mem, key_bias), cw,
               ck),
        "b3": (fq.fused_ffn_block, fq.fused_ffn_block_plain, (x,), fw, {}),
        "b4": (pq.fused_self_attention_block_q,
               pq.fused_self_attention_block_q_plain, (x,), qsw, sk),
        "b5": (pq.fused_cross_attention_block_q,
               pq.fused_cross_attention_block_q_plain, (x, mem, key_bias),
               qcw, ck),
        "b6": (pq.fused_ffn_block_q, pq.fused_ffn_block_q_plain, (x,), qfw,
               {}),
    }
    bounds = {**sweep_block_bounds(n, 4, "fp32"),
              **sweep_block_bounds(n, 4, "int8")}
    library = block_products_ms(x, mem, sw, cw, fw)
    where = f"{n} items, fp32 activations"
    result = {}
    for name, (fn, plain_fn, args, w, kw) in blocks.items():
        def kern(fn=fn, args=args, w=w, kw=kw):
            return fn(*args, **w, **kw)

        def plain(plain_fn=plain_fn, args=args, w=w, kw=kw):
            return plain_fn(*args, **w, **kw)

        fn.launches = 0
        out = kern()
        torch.cuda.synchronize()
        again = kern()
        torch.cuda.synchronize()
        if fn.launches != 2:
            raise AssertionError(f"{name.upper()} fp32: {fn.launches} "
                                 "launches for 2 calls")
        if not torch.equal(out, again):
            raise AssertionError(f"{name.upper()} fp32: a repeat gave other "
                                 "bits")
        if out.dtype != torch.float32 or out.shape != x.shape:
            raise AssertionError(f"{name.upper()} fp32: {out.dtype} "
                                 f"{tuple(out.shape)}")
        ref = plain()
        if name in ("b1", "b2", "b3"):
            err = kernel_error(f"{name.upper()} fp32", out, ref, where)
        else:
            err, cos = block_error(out, ref)
            check_block(f"{name.upper()} fp32", err, cos, where)
        t_k = time_ms(kern, iters=5, warmup=1)
        t_p = time_ms(plain, iters=3, warmup=1)
        t_k2 = time_ms(kern, iters=5, warmup=1)
        b_ms, b_by = bounds[name]
        result[name] = dict(err=err, ms=min(t_k, t_k2), plain_ms=t_p,
                            bound_ms=b_ms, bound_by=b_by,
                            library_ms=library.get(name))
        log(f"{name.upper()} fp32 time {n} items: kernel {t_k:.4f} / "
            f"{t_k2:.4f} ms, plain {t_p:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by})" + (
                f", cuBLAS fp32 for its products alone {library[name]:.4f} ms"
                if name in library else ", no library call (int8 products)"))
        del out, again, ref
    codes = b6_codes(x, qfw)
    want = pq.row_quant(x)[0].reshape(codes.shape)
    via_bf16 = pq.row_quant(x.bfloat16())[0].reshape(codes.shape)
    log(f"B6 fp32: x's int8 codes equal the plain row_quant of the fp32 x: "
        f"{bool(torch.equal(codes, want))}; quantizing x cast to bf16 first "
        f"would change {int((via_bf16 != want).sum())} of {want.numel()} "
        "codes")
    if not torch.equal(codes, want):
        raise AssertionError("B6 fp32: x's codes are not those of its fp32 "
                             "values")
    del x, mem, key_bias, sw, cw, fw, qsw, qcw, qfw, blocks
    torch.cuda.empty_cache()
    return result


def fp32_b12(gen) -> dict:
    """B12s and B12c at float32, forward and backward, at the item-training
    shape: against their plain versions (max|d| / max|ref| <= 1e-5 over each
    output, C-11's rule: a row near zero is held to its tensor's scale),
    repeated for identical bits; timed beside the plain versions, the bounds
    (operations at the fp32 rate) and multi_head_attention_forward in fp32;
    then the differentiable blocks through autograd with exact launch
    counts (the rows' launches: that run's)."""
    from unirec_tpu_torch.ops import fused_qformer_vjp as fv

    d, k, f, n = QF_D, QF_K, QF_F, FP32_B12_ITEMS
    skw = dict(num_heads=QF_HEADS, n_q=k)
    ckw = dict(skw, n_kv=f)
    x, mem, key_bias, mask, sw, cw, _ = block_inputs(gen, n, torch.float32)
    x2, mem2 = x.reshape(-1, d), mem.reshape(-1, d)
    kb = key_bias.reshape(-1).contiguous()
    zero = torch.zeros(x2.shape[0], device="cuda")
    dout = torch.randn(x2.shape, device="cuda", generator=gen) * 0.1
    sa = (x2, zero, sw["wqkv"], sw["bqkv"], sw["wo"], sw["bo"])
    ca = (x2, mem2, kb, cw["wq"], cw["bq"], cw["wkv"], cw["bkv"], cw["wo"],
          cw["bo"])
    s_out = fv.self_attention_fwd(*sa, **skw)
    c_out = fv.cross_attention_fwd(*ca, **ckw)
    qkv, q, kv = s_out[1], c_out[1], c_out[2]
    runs = {
        "b12s_fwd": (lambda: fv.self_attention_fwd(*sa, **skw),
                     lambda: fv.self_attention_fwd_plain(*sa, **skw),
                     ("out", "qkv", "ctx")),
        "b12s_bwd": (lambda: fv.self_attention_bwd(qkv, sw["wo"], zero, dout,
                                                   **skw),
                     lambda: fv.self_attention_bwd_plain(
                         qkv, sw["wo"], zero, dout, **skw), ("dqkv",)),
        "b12c_fwd": (lambda: fv.cross_attention_fwd(*ca, **ckw),
                     lambda: fv.cross_attention_fwd_plain(*ca, **ckw),
                     ("out", "q", "kv", "ctx")),
        "b12c_bwd": (lambda: fv.cross_attention_bwd(q, kv, cw["wo"], kb, dout,
                                                    **ckw),
                     lambda: fv.cross_attention_bwd_plain(
                         q, kv, cw["wo"], kb, dout, **ckw), ("dq", "dkv")),
    }
    where = f"{n} items fp32, {int((mask.sum(1) == 0).sum())} without fields"
    bounds = b12_bounds(n, 4, "fp32")
    library = b12_library_calls(x, mem, key_bias, sw, cw)
    result = {}
    for name, (kern, plain, outs) in runs.items():
        got = kern()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        ref = plain()
        ref = ref if isinstance(ref, tuple) else (ref,)
        err = max(kernel_error(f"{name.upper()} fp32 {o}", g, r, where)
                  for o, g, r in zip(outs, got, ref))
        again = kern()
        again = again if isinstance(again, tuple) else (again,)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{name.upper()} fp32: a repeat gave other "
                                 "bits")
        if name in library:  # the same function: out
            lib_out = library[name]().transpose(0, 1).reshape(-1, d)
            cos = torch.nn.functional.cosine_similarity(
                lib_out, got[0], dim=-1).min().item()
            if not cos >= 0.999:
                raise AssertionError(f"{name.upper()} fp32: the yardstick "
                                     f"computes another function ({cos})")
        t_k = time_ms(kern, iters=10, warmup=2)
        t_p = time_ms(plain, iters=3, warmup=1)
        t_k2 = time_ms(kern, iters=10, warmup=2)
        t_l = (time_ms(library[name], iters=10, warmup=2)
               if name in library else None)
        b_ms, b_by = bounds[name]
        result[name] = dict(err=err, ms=min(t_k, t_k2), plain_ms=t_p,
                            bound_ms=b_ms, bound_by=b_by, library_ms=t_l)
        log(f"{name.upper()} fp32 time {n} items: kernel {t_k:.4f} / "
            f"{t_k2:.4f} ms, plain {t_p:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by})" + (
                f", multi_head_attention_forward fp32 {t_l:.4f} ms (out only)"
                if t_l is not None
                else ", no single PyTorch call computes it"))
    # the entry points a trainer calls: the differentiable blocks
    wrappers = (fv.self_attention_fwd, fv.self_attention_bwd,
                fv.cross_attention_fwd, fv.cross_attention_bwd)
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (x, mem, sw["wqkv"], cw["wkv"])]
    for fn in wrappers:
        fn.launches = 0
    out_s = fv.fused_self_attention_train(
        leaves[0], zero.reshape(n, k), leaves[2], sw["bqkv"], sw["wo"],
        sw["bo"], num_heads=QF_HEADS)
    out_c = fv.fused_cross_attention_train(
        leaves[0], leaves[1], key_bias, cw["wq"], cw["bq"], leaves[3],
        cw["bkv"], cw["wo"], cw["bo"], num_heads=QF_HEADS)
    grads = torch.autograd.grad((out_s * out_c).sum(), leaves)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in zip(runs, wrappers)}
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    log(f"B12 fp32 through fused_self/cross_attention_train and autograd: "
        f"launches {launches} (want 1 each), gradients finite {finite}")
    if any(v != 1 for v in launches.values()) or not finite:
        raise AssertionError("B12 fp32: the autograd run's launches or "
                             "gradients are wrong")
    for name in runs:
        result[name]["launches"] = launches[name]
    del x, mem, runs, s_out, c_out, qkv, q, kv, grads, leaves
    torch.cuda.empty_cache()
    return result


def fp32_engine(smi: str) -> dict:
    """The fused engine at ``ItemQFormerConfig()`` (12 layers) on FP32_ITEMS
    items with float32 activations: ``prepare_fused_params(model, cfg,
    dtype=torch.float32)`` against the plain fp32 ``ItemQFormer`` forward
    (max|d| / max|ref| <= 1e-4, per-token cosine >= 0.99999), and the same
    with ``precision="int8"`` (per-token cosine >= 0.999 against the fp32
    model); exact launch counts of B1-B6 (the fp32 rows' launches), items/s
    and peak memory."""
    from unirec_tpu_torch.configs import ItemQFormerConfig
    from unirec_tpu_torch.inference.fused_qformer import (
        fused_qformer_forward,
        prepare_fused_params,
    )
    from unirec_tpu_torch.ops import fused_qformer_int8 as pq
    from unirec_tpu_torch.ops import fused_qformer_layer as fq
    from unirec_tpu_torch.utils.weights import init_item_qformer

    cfg = ItemQFormerConfig()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
    model = init_item_qformer(cfg, gen, device="cuda", dtype=torch.float32)
    n, f, dm = FP32_ITEMS, cfg.num_fields, cfg.field_embedding_dim
    mask = (torch.rand(n, f, device="cuda", generator=gen) > 0.15).float()
    mask[::128] = 0.0  # items with no field at all
    emb = torch.randn(n, f, dm, device="cuda", generator=gen) * mask[..., None]
    n_layers = cfg.num_hidden_layers
    n_cross = len(range(0, n_layers, cfg.qformer().cross_attention_freq))
    with torch.inference_mode():
        ref = model.query_outputs(emb, mask).float()
    result = {}
    for precision, names, blocks in (
            ("bf16", ("b1", "b2", "b3"),
             (fq.fused_self_attention_block, fq.fused_cross_attention_block,
              fq.fused_ffn_block)),
            ("int8", ("b4", "b5", "b6"),
             (pq.fused_self_attention_block_q,
              pq.fused_cross_attention_block_q, pq.fused_ffn_block_q))):
        label = "fp32" if precision == "bf16" else "int8 at fp32 activations"
        fused = prepare_fused_params(model, cfg, dtype=torch.float32,
                                     precision=precision)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in blocks:
            fn.launches = 0
        with torch.inference_mode():
            got = fused_qformer_forward(fused, cfg, emb, mask)
            torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in zip(names, blocks)}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        want = dict(zip(names, (n_layers, n_cross, n_layers)))
        if got.dtype != torch.float32 or got.shape != ref.shape:
            raise AssertionError(f"engine {label}: {got.dtype} "
                                 f"{tuple(got.shape)}")
        rel = ((got - ref).abs().max() / ref.abs().max()).item()
        cos = token_cosines(got, ref)
        with torch.inference_mode():
            rate = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fused_qformer_forward(fused, cfg, emb, mask)
                torch.cuda.synchronize()
                rate.append(n / (time.perf_counter() - t0))
        rate.sort()
        log(f"[{smi}] engine {label} at ItemQFormerConfig() ({n_layers} "
            f"layers), {n} items: vs the plain fp32 ItemQFormer max|d|/"
            f"max|ref| {rel:.3e}, min token cosine {cos.min().item():.7f} "
            f"(mean {cos.mean().item():.7f}); launches {launches} (want "
            f"{want}); median {rate[1]:.1f} items/s (min {rate[0]:.1f}, max "
            f"{rate[2]:.1f}; 3 synced batches); peak device memory "
            f"{peak_gb:.2f} GB (max_memory_allocated over the first forward, "
            "the engine's weights and the fp32 model included)")
        if launches != want:
            raise AssertionError(f"engine {label}: launches {launches}, want "
                                 f"{want}")
        if precision == "bf16" and not (
                rel <= FP32_ENGINE_REL
                and cos.min().item() >= FP32_ENGINE_COS):
            raise AssertionError("the fp32 engine disagrees with the fp32 "
                                 "ItemQFormer")
        if precision == "int8" and not cos.min().item() >= FP32_INT8_COS:
            raise AssertionError("the int8 engine at fp32 activations fails "
                                 "the int8 quality gate")
        result.update(launches)
        result[f"{label} items/s"] = rate[1]
        result[f"{label} peak GB"] = peak_gb
        del fused, got
        torch.cuda.empty_cache()
    del model, ref, emb
    torch.cuda.empty_cache()
    return result


def phase_fp32_fused(smi: str) -> dict:
    """The fp32 forms of B1-B6 and B12 (the JAX kernels take float32
    activations too): the blocks at production widths, B12 at the
    item-training shape, then the fused engine at ``ItemQFormerConfig()``.
    Each form's figures, its launches from the engine's run (B1-B6) or the
    autograd run (B12)."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
    blocks = fp32_blocks(gen)
    b12 = fp32_b12(gen)
    engine = fp32_engine(smi)
    for name in blocks:
        blocks[name]["launches"] = engine[name]
    log(f"phase fp32 fused: {time.perf_counter() - t0:.1f} s")
    return {**blocks, **b12}


def flash_inputs(gen, b, lkv, dtype, d=QF_D):
    """Merged-head q and dO [B, 64, d], k3 / v3 [B, Lkv, d], and a
    per-key bias [B, 1, 1, Lkv] with ~15% of the keys masked and batch row 1
    masked whole (a user whose history is all missing from the cache)."""
    lq = 64
    q, do = (torch.randn(b, lq, d, device="cuda", generator=gen).to(dtype)
             for _ in range(2))
    k3, v3 = (torch.randn(b, lkv, d, device="cuda", generator=gen).to(dtype)
              for _ in range(2))
    mask = (torch.rand(b, lkv, device="cuda", generator=gen) > 0.15).float()
    mask[1] = 0.0
    return q, k3, v3, do, ((1.0 - mask) * -1e9)[:, None, None, :]


def ops_kind(dtype, form=None) -> str:
    """The peak rate (``PEAK_OPS``) that bounds a kernel's products in
    ``dtype`` and chunked ``form``: bf16's, float32's 3xTF32 in the
    "cluster_tf32" form, else fp32 outside the tensor cores."""
    if dtype == torch.bfloat16:
        return "bf16"
    return "tf32x3" if form == "cluster_tf32" else "fp32"


def flash_bounds(b, lq, lkv, size, h=USER_HEADS, d=QF_D) -> dict:
    """bound_ms and bound_by of B13 and B14 at these shapes (merged width
    ``d``, QF_D by default, in ``h`` heads): q, k, v (and dO) read once and
    the outputs written once in the working type (B14's forward o in
    float32), the float32 key bias and (m, l, dsum) [B, Lq, H]; the score
    and p.v products (2 forward; s, dp, dv, dk, dq backward) at the rate of
    the form the head dim takes (``ops_kind``)."""
    hd = d // h
    dtype = torch.bfloat16 if size == 2 else torch.float32
    kind = ops_kind(dtype, chunked_forms(hd, dtype)["fwd"] if hd > 256
                    else None)
    io_q, io_kv = size * b * lq * d, size * b * lkv * d
    stats, bias = 4 * b * lq * h, 4 * b * lkv
    prod = 2 * b * lq * lkv * d  # one product over every head
    return {"b13": bound(2 * io_q + 2 * io_kv + bias, 2 * prod, kind),
            "b14_fwd": bound(io_q + 4 * b * lq * d + 2 * io_kv + bias
                             + 2 * stats, 2 * prod, kind),
            "b14_bwd": bound(3 * io_q + 4 * io_kv + bias + 3 * stats,
                             5 * prod, kind)}


def check_flash_cross(gen, dtype, b, lkv, h, hd, res) -> dict:
    """B13 and B14 (forward and backward) against their plain versions at
    one dtype, batch, memory length, head count and head dim (merged width h
    * hd), each run twice for identical bits; the fully masked user averages
    its keys uniformly.  Returns the runs and inputs, for timing, and B14's
    forward + backward as ``_FlashCrossProj`` runs them without its
    projections (``path``)."""
    from unirec_tpu_torch.ops import attention as pa
    from unirec_tpu_torch.ops import flash_vjp as fl

    where = f"{dtype} B={b} Lq=64 Lkv={lkv} H={h} hd={hd}"
    q, k3, v3, do, bias = flash_inputs(gen, b, lkv, dtype, h * hd)
    qh, kh, vh = (pa.split_heads(t, h) for t in (q, k3, v3))
    bias32 = pa.key_bias(bias, b, lkv, q.device)
    state = {}
    runs = {
        "b13": (lambda: (pa.flash_cross_attention(qh, kh, vh, bias),),
                lambda: (pa.flash_cross_attention_plain(qh, kh, vh, bias),),
                ("o",)),
        "b14_fwd": (lambda: fl.flash_cross_fwd(q, k3, v3, bias32, h),
                    lambda: fl.flash_cross_fwd_plain(q, k3, v3, bias32, h),
                    ("o", "m", "l")),
        "b14_bwd": (lambda: fl.flash_cross_bwd(q, k3, v3, bias32, do,
                                               *state["ml"], state["dsum"], h),
                    lambda: fl.flash_cross_bwd_plain(
                        q, k3, v3, bias32, do, *state["ml"], state["dsum"],
                        h), ("dq", "dk3", "dv3")),
    }
    for name, (kern, plain, outs) in runs.items():
        got = kern()
        torch.cuda.synchronize()
        check_outputs(name.upper(), outs, got, plain(), where, res[name],
                      rows32=dtype == torch.float32 and hd > 256)
        if not all(torch.equal(x, y) for x, y in zip(got, kern())):
            raise AssertionError(f"{name.upper()} {where}: a repeat gave "
                                 "other bits")
        if name == "b13":  # the masked user: its keys' plain mean
            kernel_error("B13 fully masked user", got[0][1],
                         vh[1].float().mean(1, keepdim=True).expand(
                             h, 64, hd), where)
        if name == "b14_fwd":
            state["ml"] = got[1:]
            state["dsum"] = fl.attention_dsum(do, got[0], h).contiguous()
    log(f"B13 / B14 {where}: the kernels repeat bit for bit")

    def path():
        o32, m, l = fl.flash_cross_fwd(q, k3, v3, bias32, h)
        o32.to(dtype)
        dsum = fl.attention_dsum(do, o32, h).contiguous()
        fl.flash_cross_bwd(q, k3, v3, bias32, do, m, l, dsum, h)

    return {"runs": runs, "qh": qh, "kh": kh, "vh": vh, "do": do,
            "bias": bias, "path": path}


def check_outputs(name, outs, got, ref, where, res, rows32=False) -> None:
    """Each output of a kernel against its plain version: float32 (m, l)
    statistics to 1e-5 relative, the rest by ``kernel_error`` (dq and dk
    with the GRAD_NOISE_FLOOR), or with ``rows32`` (the float32 chunked
    forms) every output by ``fp32_rows`` (max|d| and row cosine); the
    largest error goes to ``res["err"]``."""
    for o, g, r in zip(outs, got, ref):
        if rows32:
            err = fp32_rows(f"{name} {o}", g, r, where)
            if o not in ("m", "l"):
                res["err"] = max(res["err"], err)
            continue
        if o in ("m", "l"):  # float32 statistics of both
            rel = ((g - r).abs() / r.abs().clamp_min(1e-30)).max()
            log(f"{name} {o} {where}: max rel {rel.item():.3e} (tol 1e-5)")
            if not rel.item() <= 1e-5:
                raise AssertionError(f"{name} {o} {where} disagrees")
            continue
        floor = GRAD_NOISE_FLOOR if o in ("dq", "dk", "dk3") else 0.0
        res["err"] = max(res["err"], kernel_error(f"{name} {o}", g, r, where,
                                                  noise_floor=floor))


def sdpa_cosine(name, lib_out, kern_out) -> None:
    """The yardstick computes the kernel's function: min row cosine 0.999."""
    hd = kern_out.shape[-1]
    cos = torch.nn.functional.cosine_similarity(
        lib_out.float().reshape(-1, hd), kern_out.float().reshape(-1, hd),
        dim=-1).min().item()
    log(f"{name} against scaled_dot_product_attention: min row cosine "
        f"{cos:.6f} (tol 0.999)")
    if not cos >= 0.999:
        raise AssertionError(f"{name}: the yardstick computes another "
                             "function")


def time_runs(runs, library, bounds, res, where) -> None:
    """Kernel (twice), plain version, bound and SDPA of each run, into
    ``res``."""
    for name, (kern, plain, _) in runs.items():
        t_k = time_ms(kern, iters=20, warmup=3)
        t_p = time_ms(plain, iters=5, warmup=1)
        t_k2 = time_ms(kern, iters=20, warmup=3)
        t_l = time_ms(library[name], iters=20, warmup=3)
        b_ms, b_by = bounds[name]
        res[name].update(ms=min(t_k, t_k2), plain_ms=t_p, bound_ms=b_ms,
                         bound_by=b_by, library_ms=t_l)
        log(f"{name.upper()} time {where}: kernel {t_k:.4f} / {t_k2:.4f} ms,"
            f" plain {t_p:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"scaled_dot_product_attention {t_l:.4f} ms"
            + (" (forward + backward)" if name.endswith("_bwd") else ""))


def sdpa_fwd_bwd(sdpa, q, k, v, mask, do):
    """SDPA's forward + backward on copies of q, k, v that need gradients
    (made here, outside the timed call)."""
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))

    def run():
        torch.autograd.grad(sdpa(qg, kg, vg, attn_mask=mask), (qg, kg, vg),
                            do)
    return run


def phase_flash_cross(gen) -> dict:
    """B13 and B14 (forward and backward) against their plain versions, in
    fp32 and bf16, at the user stage's batch (64 users, 1,600 memory rows)
    and over a ragged 1,000-row memory in 16 heads of 64, and over the
    ragged memory at the other head dims (FLASH_OTHER_HD: heads of the same
    width, 16 heads where the head dim does not divide it); each run twice
    for identical bits.  Timed in bf16 at the user shape beside the plain
    versions, the bounds and ``scaled_dot_product_attention`` (forward for
    B13 and B14's forward, forward + backward for B14's backward, which
    also gets ``path_ms``: B14's forward + backward as the autograd
    Function runs them, without its projections)."""
    from unirec_tpu_torch.ops import attention as pa

    sdpa = torch.nn.functional.scaled_dot_product_attention
    res = {n: {"err": 0.0} for n in ("b13", "b14_fwd", "b14_bwd")}
    cases = [(dtype, b, lkv, USER_HEADS, QF_D // USER_HEADS)
             for dtype in (torch.float32, torch.bfloat16)
             for b, lkv in ((USER_BATCH, USER_SEQ * QF_K), USER_RAGGED)]
    cases += [(dtype, *USER_RAGGED,
               QF_D // hd if QF_D % hd == 0 else USER_HEADS, hd)
              for hd in FLASH_OTHER_HD
              for dtype in (torch.float32, torch.bfloat16)]
    for dtype, b, lkv, h, hd in cases:
        c = check_flash_cross(gen, dtype, b, lkv, h, hd, res)
        if dtype == torch.bfloat16 and b == USER_BATCH:
            mask = c["bias"].to(dtype)
            qh, kh, vh = c["qh"], c["kh"], c["vh"]
            sdpa_cosine("B13", sdpa(qh, kh, vh, attn_mask=mask),
                        c["runs"]["b13"][0]()[0])
            library = {"b13": lambda: sdpa(qh, kh, vh, attn_mask=mask),
                       "b14_fwd": lambda: sdpa(qh, kh, vh, attn_mask=mask),
                       "b14_bwd": sdpa_fwd_bwd(sdpa, qh, kh, vh, mask,
                                               pa.split_heads(c["do"], h))}
            time_runs(c["runs"], library, flash_bounds(b, 64, lkv, 2), res,
                      f"{dtype} B={b} Lq=64 Lkv={lkv}")
            res["b14_bwd"]["path_ms"] = time_ms(c["path"], iters=20,
                                                warmup=3)
            log(f"B14 forward + backward through the Function's kernels "
                f"{dtype} B={b} Lq=64 Lkv={lkv}: "
                f"{res['b14_bwd']['path_ms']:.4f} ms (SDPA forward + "
                f"backward {res['b14_bwd']['library_ms']:.4f} ms)")
        elif dtype == torch.bfloat16:  # the ragged memory at each head dim
            log(f"B13 / B14 kernel times {dtype} B={b} Lq=64 Lkv={lkv} "
                f"H={h} hd={hd}: " + ", ".join(
                    f"{name} {time_ms(kern, iters=10):.4f} ms"
                    for name, (kern, _, _) in c["runs"].items()))
        del c
        torch.cuda.empty_cache()
    return res


# -- B14p: trainable flash cross-attention over per-head tensors -------------


def b14p_inputs(gen, b, h, lq, lkv, hd, dtype):
    """Per-head q and dO [B, H, Lq, hd], k / v [B, H, Lkv, hd], and a
    per-key bias [B, 1, 1, Lkv] with ~15% of the keys masked and batch row 1
    masked whole."""
    q, do = (torch.randn(b, h, lq, hd, device="cuda", generator=gen).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, h, lkv, hd, device="cuda", generator=gen).to(dtype)
            for _ in range(2))
    mask = (torch.rand(b, lkv, device="cuda", generator=gen) > 0.15).float()
    mask[1] = 0.0
    return q, k, v, do, ((1.0 - mask) * -1e9)[:, None, None, :]


def phase_b14p(gen) -> dict:
    """B14p, ``flash_cross_attention_vjp``, driven as a user calls it: every
    case's inputs need gradients, the output goes through
    ``torch.autograd.grad``, with the launch counts set to 0 before and read
    after (one forward and one backward a case).  The cases: the user
    stage's shape in per-head layout (64 users x 16 heads x 64 queries over
    1,600 memory rows, hd 64) and a ragged 1,000-row memory (8 users), ~15%
    masked keys and one user masked whole, the JAX tests' shape (2 x 3
    heads x 16 queries over 384 keys, hd 32), 200 queries (four q tiles: the
    bf16 backward's partial dk / dv and their sum) and one query over the
    ragged memory; fp32 and bf16.  Then the
    output and gradients against the plain path's, the kernels (forward:
    o, m, l; backward: dq, dk, dv) against their plain versions, identical
    bits on a repeat, exactly zero dk / dv at masked keys, the masked user's
    uniform average; timed in bf16 at the user shape beside the plain
    versions, the bounds and SDPA."""
    from unirec_tpu_torch.ops import attention as pa
    from unirec_tpu_torch.ops import flash_vjp as fl

    sdpa = torch.nn.functional.scaled_dot_product_attention
    shapes = ((USER_BATCH, USER_HEADS, 64, USER_SEQ * QF_K, 64),
              (USER_RAGGED[0], USER_HEADS, 64, USER_RAGGED[1], 64),
              (2, 3, 16, 384, 32),
              (USER_RAGGED[0], 4, 200, USER_RAGGED[1], 64),
              (USER_RAGGED[0], USER_HEADS, 1, USER_RAGGED[1], 64))
    cases = [(dtype, *shape) for dtype in (torch.float32, torch.bfloat16)
             for shape in shapes]
    inputs = {case: b14p_inputs(gen, *case[1:], case[0]) for case in cases}
    # the entry point's run: its launches
    fl.flash_cross_vjp_fwd.launches = fl.flash_cross_vjp_bwd.launches = 0
    driven = {}
    for case in cases:
        q, k, v, do, bias = inputs[case]
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fl.flash_cross_attention_vjp(*leaves, bias)
        driven[case] = (out.detach(), torch.autograd.grad(out, leaves, do))
    torch.cuda.synchronize()
    launches = {"b14p_fwd": fl.flash_cross_vjp_fwd.launches,
                "b14p_bwd": fl.flash_cross_vjp_bwd.launches}
    log(f"B14p launches through flash_cross_attention_vjp: {launches} over "
        f"{len(cases)} calls")
    if launches != {"b14p_fwd": len(cases), "b14p_bwd": len(cases)}:
        raise AssertionError(f"B14p launches {launches}")
    res = {n: {"err": 0.0} for n in ("b14p_fwd", "b14p_bwd")}
    for case in cases:
        dtype, b, h, lq, lkv, hd = case
        where = f"{dtype} B={b} H={h} Lq={lq} Lkv={lkv} hd={hd}"
        q, k, v, do, bias = inputs[case]
        bias32 = pa.key_bias(bias, b, lkv, q.device)
        # the entry point against the plain path
        o32, m, l = fl.flash_cross_vjp_fwd_plain(q, k, v, bias32)
        dsum = (do.float() * o32).sum(-1).transpose(1, 2).contiguous()
        plain_grads = fl.flash_cross_vjp_bwd_plain(q, k, v, bias32, do, m, l,
                                                   dsum)
        out, grads = driven.pop(case)
        res["b14p_fwd"]["err"] = max(res["b14p_fwd"]["err"], kernel_error(
            "B14P out (autograd)", out, o32.to(dtype), where))
        for name, g, r in zip("qkv", grads, plain_grads):
            res["b14p_bwd"]["err"] = max(res["b14p_bwd"]["err"], kernel_error(
                f"B14P d{name} (autograd)", g, r, where,
                noise_floor=GRAD_NOISE_FLOOR if name in "qk" else 0.0))
        # the kernels against their plain versions, on the same (m, l, dsum)
        state = {}
        runs = {
            "b14p_fwd": (lambda: fl.flash_cross_vjp_fwd(q, k, v, bias32),
                         lambda: fl.flash_cross_vjp_fwd_plain(q, k, v,
                                                              bias32),
                         ("o", "m", "l")),
            "b14p_bwd": (lambda: fl.flash_cross_vjp_bwd(
                             q, k, v, bias32, do, *state["mld"]),
                         lambda: fl.flash_cross_vjp_bwd_plain(
                             q, k, v, bias32, do, *state["mld"]),
                         ("dq", "dk", "dv")),
        }
        for name, (kern, plain, outs) in runs.items():
            got = kern()
            torch.cuda.synchronize()
            check_outputs(name.upper(), outs, got, plain(), where, res[name])
            if not all(torch.equal(x, y) for x, y in zip(got, kern())):
                raise AssertionError(f"{name.upper()} {where}: a repeat gave "
                                     "other bits")
            if name == "b14p_fwd":
                kernel_error("B14P fully masked user", got[0][1],
                             v[1].float().mean(1, keepdim=True).expand(
                                 h, lq, hd), where)
                state["mld"] = (got[1], got[2], (do.float() * got[0]).sum(
                    -1).transpose(1, 2).contiguous())
            else:  # masked keys of users with a valid key: exactly zero
                masked = bias32 != 0
                masked[1] = False
                if not all(bool((g.transpose(1, 2)[masked] == 0).all())
                           for g in got[1:]):
                    raise AssertionError(f"B14P {where}: masked keys got a "
                                         "gradient")
        log(f"B14p {where}: the kernels repeat bit for bit, masked keys get "
            "exactly zero dk / dv")
        if dtype == torch.bfloat16 and b == USER_BATCH:
            mask = bias.to(dtype)
            sdpa_cosine("B14P", sdpa(q, k, v, attn_mask=mask),
                        runs["b14p_fwd"][0]()[0])
            library = {"b14p_fwd": lambda: sdpa(q, k, v, attn_mask=mask),
                       "b14p_bwd": sdpa_fwd_bwd(sdpa, q, k, v, mask, do)}
            bounds = flash_bounds(b, lq, lkv, 2)
            time_runs(runs, library, {"b14p_fwd": bounds["b14_fwd"],
                                      "b14p_bwd": bounds["b14_bwd"]}, res,
                      where)
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            res["b14p_bwd"]["path_ms"] = time_ms(
                lambda: torch.autograd.grad(
                    fl.flash_cross_attention_vjp(*leaves, bias), leaves, do),
                iters=20, warmup=3)
            log(f"B14p forward + backward through flash_cross_attention_vjp"
                f" {where}: {res['b14p_bwd']['path_ms']:.4f} ms (SDPA "
                f"forward + backward {res['b14p_bwd']['library_ms']:.4f} ms)")
            del leaves
        del runs, state
        torch.cuda.empty_cache()
    for name in res:
        res[name]["launches"] = launches[name]
    return res


# -- B15: packed item attention ----------------------------------------------


def b15_bound(items, h, n_q, n_kv, hd, size):
    """B15's least time: q, k, v read and o written once in the working
    type, the float32 key bias; the score and value products."""
    nbytes = size * items * h * hd * (2 * n_q + 2 * n_kv) + 4 * items * n_kv
    ops = 2 * 2 * items * h * n_q * n_kv * hd
    return bound(nbytes, ops, "bf16" if size == 2 else "fp32")


def b15_inputs(gen, items, n_q, n_kv, hd, dtype, missing=0.0):
    """q [items, 16, K, hd], k / v [items, 16, F, hd] as per-head views of
    merged [items, L, 16 * hd] tensors (the Q-Former's layout), and a
    per-key bias with ``missing`` of the fields masked and every 125th item
    without a field (none when ``missing`` is 0)."""
    def rand(n):
        return (torch.randn(items, n, QF_HEADS, hd, device="cuda",
                            generator=gen).to(dtype).transpose(1, 2))

    mask = (torch.rand(items, n_kv, device="cuda", generator=gen)
            >= missing).float()
    if missing:
        mask[::125] = 0.0
    return (rand(n_q), rand(n_kv), rand(n_kv),
            ((1.0 - mask) * -1e9)[:, None, None, :], mask)


def phase_b15(gen, extra_gen) -> dict:
    """B15, ``packed_item_attention``, with the launch count set to 0 before
    its cases and read after (one launch a case): the item sweep's self
    shape (4096 items x 16 heads, K = F = 32, hd 64) and cross shape (F =
    14), a ragged 1,001 items over 14 fields with ~15% missing and 9 items
    without any, and K = 2 (1,001 items, F = 14, hd 32), the ragged items at
    hd 8 and 24, and B15_SHAPES (head dims above 128, K = 128 over 512 keys,
    K = 2 over 600); fp32 and bf16.
    Each against the plain version, repeated for identical bits, the items
    without a field against their own values' mean; timed in bf16 at the
    two sweep shapes beside the plain version, the bound and SDPA."""
    from unirec_tpu_torch.ops import packed_attention as pp

    sdpa = torch.nn.functional.scaled_dot_product_attention
    shapes = ((SWEEP_BATCH, QF_K, QF_K, 64, 0.0),
              (SWEEP_BATCH, QF_K, QF_F, 64, 0.0),
              (BLOCK_ITEMS[1], QF_K, QF_F, 64, 0.15),
              (BLOCK_ITEMS[1], 2, QF_F, 32, 0.15),
              (BLOCK_ITEMS[1], QF_K, QF_F, 8, 0.15),
              (BLOCK_ITEMS[1], QF_K, QF_F, 24, 0.15),
              *B15_SHAPES)
    cases = [(dtype, shape) for dtype in (torch.float32, torch.bfloat16)
             for shape in shapes]
    inputs = {case: b15_inputs(extra_gen if case[1] in B15_SHAPES else gen,
                               *case[1][:4], case[0], case[1][4])
              for case in cases}
    # the entry point's run: its launches
    pp.packed_item_attention.launches = 0
    outs = {case: pp.packed_item_attention(*inputs[case][:4])
            for case in cases}
    torch.cuda.synchronize()
    n = pp.packed_item_attention.launches
    log(f"B15 launches through packed_item_attention: {n} over {len(cases)} "
        "calls")
    if n != len(cases):
        raise AssertionError(f"B15 launches {n}")
    res = {"err": 0.0, "launches": n, "timed": []}
    for case in cases:
        dtype, shape = case
        items, n_q, n_kv, hd, missing = shape
        q, k, v, bias, mask = inputs.pop(case)
        out = outs.pop(case)
        where = (f"{dtype} {items} items x {QF_HEADS} heads, K={n_q} "
                 f"F={n_kv} hd={hd}, {int((mask.sum(1) == 0).sum())} "
                 "without fields")
        res["err"] = max(res["err"], kernel_error(
            "B15", out, pp.packed_item_attention_plain(q, k, v, bias),
            where))
        if not torch.equal(out, pp.packed_item_attention(q, k, v, bias)):
            raise AssertionError(f"B15 {where}: a repeat gave other bits")
        none = mask.sum(1) == 0
        if none.any():
            kernel_error("B15 items without fields", out[none],
                         v[none].float().mean(2, keepdim=True).expand(
                             -1, -1, n_q, -1), where)
        log(f"B15 {where}: repeats bit for bit")
        if dtype == torch.bfloat16 and not missing:
            mask_f = bias.to(dtype)
            sdpa_cosine("B15", sdpa(q, k, v, attn_mask=mask_f), out)
            timed = {"b15": {"F": n_kv}}
            time_runs(
                {"b15": (lambda: pp.packed_item_attention(q, k, v, bias),
                         lambda: pp.packed_item_attention_plain(q, k, v, bias),
                         None)},
                {"b15": lambda: sdpa(q, k, v, attn_mask=mask_f)},
                {"b15": b15_bound(items, QF_HEADS, n_q, n_kv, hd, 2)}, timed,
                where)
            res["timed"].append(timed["b15"])
        del q, k, v, bias, mask, out
        torch.cuda.empty_cache()
    return res


def b11_compare(users, codes, scales, k):
    """B11 vs its plain version; returns the max score difference."""
    return retrieval_check("B11", users, codes, k, scales)


def phase_b11(gen) -> dict:
    from unirec_tpu_torch.ops.losses import l2_normalize
    from unirec_tpu_torch.ops.quantization import (
        quantize_rows,
        quantized_top_k,
        retrieve_top_k_int8,
    )

    codes, scales = quantize_rows(
        torch.randn(CATALOG, DIM, device="cuda", generator=gen))
    deq = codes.float() * scales[:, None]
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    times = {}
    for n_users in K2_USERS:
        users = torch.randn(n_users, DIM, device="cuda", generator=gen)
        b11_compare(users, codes, scales, K2_K)
        u_n = l2_normalize(users)
        log(f"B11 int8 catalog {CATALOG} x {DIM}, "
            f"{codes.numel() / 1e6:.1f} MB of codes")
        times[n_users] = retrieval_times(
            "B11", n_users, 1,
            lambda: retrieve_top_k_int8(users, codes, scales, k=K2_K),
            lambda: quantized_top_k(users, codes, scales, k=K2_K),
            lambda: torch.topk(u_n @ deq.T, K2_K), flush)
        log_split(f"B11 users={n_users}",
                  lambda: retrieve_top_k_int8(users, codes, scales, k=K2_K))
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
    with bf16-rounded random weights quantized per output column; each
    timed, with the device time of each of its launches (``log_split``) and
    ``torch._int_mm``'s time for its product(s) alone (the yardstick)."""
    from unirec_tpu_torch.ops import fused_qwen3_int8 as pf
    from unirec_tpu_torch.ops.fused_qformer_int8 import quantize_weight
    from unirec_tpu_torch.ops.int8_matmul import int8_linear, int8_linear_plain

    def rand(*shape, std=1.0):
        return (torch.randn(*shape, device="cuda", generator=gen) * std
                ).bfloat16()

    def timed(name, kern, plain, products):
        t_k = time_ms(kern, iters=20)
        t_p = time_ms(plain, iters=5, warmup=1)
        t_k2 = time_ms(kern, iters=20)
        t_l = time_ms(lambda: [torch._int_mm(a, w.t()) for a, w in products],
                      iters=20)
        log(f"{name} time: kernel {t_k:.4f} / {t_k2:.4f} ms, plain "
            f"{t_p:.4f} ms, torch._int_mm (the product{'s' * (len(products) > 1)} "
            f"alone) {t_l:.4f} ms")
        log_split(name, kern)
        return dict(ms=min(t_k, t_k2), plain_ms=t_p, library_ms=t_l)

    def codes(rows, k):  # operands of the yardstick's product
        return torch.randint(-127, 128, (rows, k), device="cuda",
                             generator=gen, dtype=torch.int8)

    out = {"b8": {"err": 0.0}}
    for rows, k, n in B8_SHAPES:
        x = rand(rows, k)
        x[5] = 0.0  # a row below the absmax floor
        wq, ws = quantize_weight(rand(n, k, std=0.03))
        where = f"[{rows}, {k}] -> {n}"
        err = check_int8_linear("B8", int8_linear(x, wq, ws),
                                int8_linear_plain(x, wq, ws), where)
        out["b8"]["err"] = max(out["b8"]["err"], err)
        t = timed(f"B8 {where}", lambda: int8_linear(x, wq, ws),
                  lambda: int8_linear_plain(x, wq, ws),
                  [(codes(rows, k), wq)])
        out["b8"][(rows, k, n)] = t
        if (rows, k, n) == B8_SHAPES[0]:
            out["b8"].update(t)
    x = rand(B9_ROWS, QW_D)
    wqkv, sqkv = quantize_weight(rand(QW_QKV, QW_D, std=0.03))
    where = f"[{B9_ROWS}, {QW_D}] -> {QW_QKV}"
    err = check_int8_linear("B9A", pf.qkv_int8(x, wqkv, sqkv),
                            pf.qkv_int8_plain(x, wqkv, sqkv), where)
    out["b9a"] = dict(err=err, **timed(
        f"B9A {where}", lambda: pf.qkv_int8(x, wqkv, sqkv),
        lambda: pf.qkv_int8_plain(x, wqkv, sqkv),
        [(codes(B9_ROWS, QW_D), wqkv)]))
    wgu, sgu = quantize_weight(rand(2 * QW_I, QW_D, std=0.03))
    wd, sd = quantize_weight(rand(QW_D, QW_I, std=0.02))
    args = (x, wgu, sgu, wd, sd)
    where = f"[{B9_ROWS}, {QW_D}], I {QW_I}"
    err = check_swiglu(pf.swiglu_mlp_int8(*args),
                       pf.swiglu_mlp_int8_plain(*args), where)
    out["b9b"] = dict(err=err, **timed(
        f"B9B {where}", lambda: pf.swiglu_mlp_int8(*args),
        lambda: pf.swiglu_mlp_int8_plain(*args),
        [(codes(B9_ROWS, QW_D), wgu), (codes(B9_ROWS, QW_I), wd)]))
    return out


# -- phase 4: the serving slice ----------------------------------------------


def build_stack():
    from unirec_tpu_torch.configs import (
        ItemQFormerConfig,
        JointModelConfig,
        LoRAConfig,
        Qwen3Config,
    )
    from unirec_tpu_torch.data.cache import FieldEmbeddingCache
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
        hidden, cos, sin, pad_mask = seen["attn0"][:4]
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
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec.recommend(batch, k=SERVE_K)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = device_time_by_kernel(prof)
    total = sum(t for _, t in rows)
    log(f"[{smi}] bf16 recommend(), batch {BATCH}, under torch.profiler: "
        f"{total:.2f} ms of device time in {len(rows)} kernels over "
        f"{wall:.1f} ms of wall time (device idle "
        f"{100 * (1 - total / wall):.1f}%)"
        + ("" if rows else " (no device rows: breakdown not measured)"))
    for name, t in rows[:12]:
        log(f"  {t:9.3f} ms {100 * t / total:5.1f}%  {name[:110]}")
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

    int8_batch_profile(smi, fused, histories)

    after = model_checksum(shared)
    if after != before or shared.lora is None or (
            shared.qwen_config.fused_int8_inference):
        raise AssertionError("an int8 recommender changed the shared model")
    log(f"the shared bf16 model is unchanged: {len(before)} tensors, checksum "
        f"{sum(c for _, c, _ in before)} before and after")
    del fused
    return {"launches": http_launches, "errs": errs}


def int8_batch_profile(smi: str, rec8, histories) -> float:
    """One batch of ``BATCH`` users through the int8 recommender ``rec8``
    (phase 4 (b)) under ``torch.profiler``: its device time (returned) and
    the kernels that take it."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        rec8.encode_users(histories[:BATCH])
        torch.cuda.synchronize()
    rows = device_time_by_kernel(prof)
    total = sum(t for _, t in rows)
    log(f"[{smi}] int8 (b): one batch of {BATCH} users under torch.profiler: "
        f"{total:.2f} ms of device time in {len(rows)} kernels"
        + ("" if rows else " (no device rows: breakdown not measured)"))
    for name, t in rows[:12]:
        log(f"  {t:9.3f} ms {100 * t / total:5.1f}%  {name[:110]}")
    return total


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


def phase_entry_point(smi: str, rec, tmp: str) -> dict:
    """serve_cli.build_recommender(parse_args([...])) with --precision int8
    --merge-lora on a saved full-width K=2 Item Q-Former checkpoint, a field
    cache directory and JSON item and catalog files of ENTRY_ITEMS items
    written from the serving stack into ``tmp`` (the front-end phase's
    ``users`` reads them); one batch answered through it."""
    from unirec_tpu_torch.cli import serve_cli
    from unirec_tpu_torch.utils.checkpoint import save_checkpoint

    ids = rec.catalog_ids[:ENTRY_ITEMS]
    os.makedirs(tmp, exist_ok=True)
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


# -- phase 6: joint training ----------------------------------------------------


def single_key_rows(mask: torch.Tensor, heads: int) -> torch.Tensor:
    """The query rows whose causal window holds one valid key (key 0), per
    (batch, row, head) in the row order of a [B, L, heads * hd] tensor.
    Their exact dq is 0 (a softmax over one key has no gradient: ds = p (dp
    - dsum) with p = 1 and dsum = dp), so what a kernel and the plain
    version return there is rounding noise along k_0, whose sign decides
    the row cosine; max|d| still holds those rows."""
    one = mask.cumsum(1) == 1
    return one[:, :, None].expand(-1, -1, heads).reshape(-1)


def lone_key_rows(mask: torch.Tensor, heads: int) -> torch.Tensor:
    """dk's rows of exact value 0, per (batch, key, KV head) in the row
    order of a [B, L, heads * hd] tensor: key 0 of a batch row whose only
    valid key it is (every query attends it alone, as in
    ``single_key_rows``)."""
    lone = torch.zeros_like(mask, dtype=torch.bool)
    lone[:, 0] = mask.sum(1) == 1
    return lone[:, :, None].expand(-1, -1, heads).reshape(-1)


def check_b7b(name, out, ref, dtype, rows_cos=True, hd=K1_SHAPE["HD"],
              noise_rows=None) -> float:
    """max|d| / max|ref| within B7B_TOL, and (for tensors of head rows of
    width hd) per-row cosine over the rows where ref is nonzero, but for
    ``noise_rows`` (rows whose exact value is 0: ``single_key_rows``,
    ``lone_key_rows``)."""
    a, b = out.float(), ref.float()
    if not bool(torch.isfinite(a).all()):
        raise AssertionError(f"B7b {name} is not finite")
    err = (a - b).abs().max().item()
    rel = err / b.abs().max().item()
    cos = 1.0
    if rows_cos:
        a2, b2 = a.reshape(-1, hd), b.reshape(-1, hd)
        live = b2.abs().amax(-1) > 0
        if noise_rows is not None:
            live &= ~noise_rows
        cos = torch.nn.functional.cosine_similarity(
            a2[live], b2[live], dim=-1).min().item()
    log(f"B7b {dtype} {name}: max|d| {err:.3e} = {rel:.2e} of max|ref| (tol "
        f"{B7B_TOL[dtype]:g}), min row cosine {cos:.7f} (tol {B7B_COS})")
    if not (rel <= B7B_TOL[dtype] and cos >= B7B_COS):
        raise AssertionError(f"B7b {dtype} {name} disagrees with its plain "
                             "version")
    return err


def b7b_errors(q, k, v, do, mask, hq, hkv, hd) -> tuple:
    """K1's training form (o, m, l) and B7b's dq and dk/dv kernels against
    their plain versions (check_b7b), each repeated for identical bits, and
    padded keys' dk / dv exactly 0; returns (errors, the kernels' args)."""
    from unirec_tpu_torch.ops import flash_causal as fc

    dtype = q.dtype
    o, m, den = fc._k1(q, k, v, mask, hq, hkv, stats=True)
    check_repeat(f"K1 (m, l) hd {hd} {dtype}", (o, m, den),
                 fc._k1(q, k, v, mask, hq, hkv, stats=True))
    torch.cuda.synchronize()
    ref = fc.flash_causal_attention_fwd_plain(q.float(), k.float(),
                                              v.float(), mask, hq, hkv)
    errs = {name: check_b7b(name, got, want, dtype, rows, hd)
            for name, got, want, rows in (("o", o, ref[0], True),
                                          ("m", m, ref[1], False),
                                          ("l", den, ref[2], False))}
    dsum = fc.attention_dsum(do, o, hq).contiguous()
    args = (q, k, v, mask, do, m, den, dsum, hq, hkv)
    dq = fc.flash_causal_bwd_dq(*args)
    dk, dv = fc.flash_causal_bwd_dkv(*args)
    check_repeat(f"B7b dq hd {hd} {dtype}", [dq], [fc.flash_causal_bwd_dq(*args)])
    check_repeat(f"B7b dk/dv hd {hd} {dtype}", (dk, dv),
                 fc.flash_causal_bwd_dkv(*args))
    torch.cuda.synchronize()
    want = fc.flash_causal_attention_bwd_plain(
        q.float(), k.float(), v.float(), mask, do.float(), m, den, dsum,
        hq, hkv)
    for name, got, ref_ in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        noise = {"dq": single_key_rows(mask, hq),
                 "dk": lone_key_rows(mask, hkv)}.get(name)
        errs[name] = check_b7b(name, got, ref_, dtype, True, hd, noise)
    padded = mask == 0
    if not (bool((dk[padded] == 0).all()) and bool((dv[padded] == 0).all())):
        raise AssertionError("B7b gave a padded key a gradient")
    return errs, args


def phase_b7b(gen) -> dict:
    """K1's training form (o, m, l) and B7b's two kernels against their plain
    versions at the joint training shape, with random right padding (key 0
    valid), and K1 in both forms and B7b at the other head dims
    (CAUSAL_OTHER: 64, 32, 8 and 24 zero-padded, 256), fp32 and bf16,
    repeats identical; times against the plain versions and
    scaled_dot_product_attention forward + backward (the yardstick), and
    the kernels alone in bf16 at each other head dim."""
    from unirec_tpu_torch.ops import flash_causal as fc

    b, l, hq, hkv, hd = (K1_SHAPE[x] for x in ("B", "L", "HQ", "HKV", "HD"))
    lengths = torch.randint(1, l + 1, (b,), device="cuda", generator=gen)
    lengths[-1] = l
    mask = (torch.arange(l, device="cuda")[None] < lengths[:, None]).float()
    pairs = causal_pairs(mask)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (torch.randn(b, l, h * hd, device="cuda", generator=gen)
                       .to(dtype) for h in (hq, hkv, hkv, hq))
        errs, args = b7b_errors(q, k, v, do, mask, hq, hkv, hd)

        t_dq = time_ms(lambda: fc.flash_causal_bwd_dq(*args), iters=10)
        t_dkv = time_ms(lambda: fc.flash_causal_bwd_dkv(*args), iters=10)
        t_fwd = time_ms(lambda: fc._k1(q, k, v, mask, hq, hkv, stats=True),
                        iters=10)
        t_plain = time_ms(lambda: fc.flash_causal_attention_bwd_plain(*args),
                          iters=3, warmup=1)
        qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))

        def kernel_path():
            fc.flash_causal_attention_train(qs, ks, vs, mask, hq, hkv,
                                            mask_checked=True).backward(do)

        def plain_path():
            out_ = fc.flash_causal_attention_plain(qs, ks, vs, mask, hq, hkv)
            out_.backward(do)

        qh, kh, vh, allowed = sdpa_inputs(qs, ks, vs, mask, hq, hkv)
        doh = do.reshape(b, l, hq, hd).transpose(1, 2)

        def library():
            sdpa(qh, kh, vh, attn_mask=allowed).backward(doh,
                                                         retain_graph=True)

        t_path = time_ms(kernel_path, iters=5)
        t_plain_path = time_ms(plain_path, iters=3, warmup=1)
        t_lib = time_ms(library, iters=5)
        t_dq2 = time_ms(lambda: fc.flash_causal_bwd_dq(*args), iters=10)
        t_dkv2 = time_ms(lambda: fc.flash_causal_bwd_dkv(*args), iters=10)
        size = q.element_size()
        kind = "bf16" if dtype == torch.bfloat16 else "fp32"
        stats = 3 * 4 * b * l * hq + 4 * b * l  # m, l, dsum and the mask
        bq, bkv = size * b * l * hq * hd, size * b * l * hkv * hd
        # K and V read at the valid keys only; dK and dV written in full
        kv_read = 2 * bkv * float(mask.sum()) / mask.numel()
        b_dq = bound(3 * bq + kv_read + stats, 3 * 2 * hd * pairs * hq, kind)
        b_dkv = bound(2 * bq + kv_read + 2 * bkv + stats,
                      4 * 2 * hd * pairs * hq, kind)
        out[dtype] = dict(
            errs=errs,
            dq=dict(ms=min(t_dq, t_dq2), plain_ms=t_plain, library_ms=t_lib,
                    bound_ms=b_dq[0], bound_by=b_dq[1], path_ms=t_path),
            dkv=dict(ms=min(t_dkv, t_dkv2), plain_ms=t_plain, library_ms=t_lib,
                     bound_ms=b_dkv[0], bound_by=b_dkv[1], path_ms=t_path))
        log(f"B7b time {dtype} B={b} L={l} Hq={hq} Hkv={hkv} hd={hd} (row "
            f"lengths {lengths.tolist()}, {pairs} causal pairs per head): dq "
            f"kernel {t_dq:.4f} / {t_dq2:.4f} ms (bound {b_dq[0]:.4f}, "
            f"{b_dq[1]}), dkv kernel {t_dkv:.4f} / {t_dkv2:.4f} ms (bound "
            f"{b_dkv[0]:.4f}, {b_dkv[1]}), K1 with (m, l) {t_fwd:.4f} ms; "
            f"plain backward {t_plain:.4f} ms; forward + backward: kernels "
            f"{t_path:.4f} ms, plain {t_plain_path:.4f} ms, "
            f"scaled_dot_product_attention {t_lib:.4f} ms")
        del qs, ks, vs, qh, kh, vh
        torch.cuda.empty_cache()
    # the other head dims, after the timed shape (whose random row lengths
    # stay the ones earlier PRs timed)
    b, l, hq, hkv = (CAUSAL_OTHER[x] for x in ("B", "L", "HQ", "HKV"))
    for hd in CAUSAL_OTHER["HD"]:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do, mask = causal_inputs(gen, b, l, hq, hkv, hd, dtype,
                                              CAUSAL_OTHER["LENGTHS"])
            check_k1(*k1_error(q, k, v, mask, hq, hkv), dtype,
                     f"phase 3, hd {hd}, B={b}, row lengths "
                     f"{list(CAUSAL_OTHER['LENGTHS'])}")
            check_repeat(f"K1 hd {hd} {dtype}",
                         [fc.flash_causal_attention(q, k, v, mask, hq, hkv)],
                         [fc.flash_causal_attention(q, k, v, mask, hq, hkv)])
            log(f"B7b at hd {hd}, B={b} L={l} Hq={hq} Hkv={hkv}, row lengths "
                f"{list(CAUSAL_OTHER['LENGTHS'])}:")
            errs, args = b7b_errors(q, k, v, do, mask, hq, hkv, hd)
            for name, err in errs.items():
                out[dtype]["errs"][name] = max(out[dtype]["errs"][name], err)
            if dtype == torch.bfloat16:
                t_k1 = time_ms(lambda: fc.flash_causal_attention(
                    q, k, v, mask, hq, hkv), iters=10)
                t_dq = time_ms(lambda: fc.flash_causal_bwd_dq(*args),
                               iters=10)
                t_dkv = time_ms(lambda: fc.flash_causal_bwd_dkv(*args),
                                iters=10)
                log(f"K1 / B7b kernel times {dtype} hd {hd}, B={b} L={l}: K1 "
                    f"{t_k1:.4f} ms, dq {t_dq:.4f} ms, dk/dv {t_dkv:.4f} ms")
    return out


def phase_head_dims(gen) -> None:
    """C-4 on the card: a tiny Qwen3 (``tiny_qwen3_config``) at head_dim 64,
    16, 8 (zero-padded to 16) and 256, bf16 compute over float32 parameters, right-padded rows (one
    whose last three key tiles are padding): the deterministic forward
    through K1 and a flash-VJP training forward + backward through K1 with
    (m, l) and B7b, with exact launch counts, held to the same weights on
    the plain attention path (no launches): the loss (mean squared distance
    of the hidden states from a fixed random target) within STEP_LOSS_REL,
    and the per-row cosine of the forward's hidden states and every
    parameter's gradient at least STEP_GRAD_COS."""
    import dataclasses

    from unirec_tpu_torch.configs import tiny_qwen3_config
    from unirec_tpu_torch.models.qwen3 import Qwen3Model
    from unirec_tpu_torch.ops import flash_causal as fc

    counters = (fc.flash_causal_attention, fc.flash_causal_bwd_dq,
                fc.flash_causal_bwd_dkv)
    b, l = 4, 512
    lengths = (512, 320, 129, 5)
    for hd in (64, 16, 8, 256):
        cfg = tiny_qwen3_config(head_dim=hd, flash_vjp_attention=True)
        models = []
        for flash in (True, False):
            m = Qwen3Model(dataclasses.replace(cfg, flash_vjp_attention=flash),
                           device="cuda", dtype=torch.bfloat16,
                           param_dtype=torch.float32)
            models.append(m)
        with torch.no_grad():
            for p in models[0].parameters():
                p.normal_(0.0, 0.02, generator=gen)
            for name, p in models[0].named_parameters():
                if name.endswith("norm.weight"):
                    p.fill_(1.0)
        models[1].load_state_dict(models[0].state_dict())
        ids = torch.randint(0, cfg.vocab_size, (b, l), device="cuda",
                            generator=gen)
        mask = (torch.arange(l, device="cuda")[None]
                < torch.as_tensor(lengths, device="cuda")[:, None]).float()
        target = torch.randn(b, l, cfg.hidden_size, device="cuda",
                             generator=gen)

        def run(model, train):
            for fn in counters:
                fn.launches = 0
            model.train(train)
            for p in model.parameters():
                p.grad = None
            with torch.set_grad_enabled(train):
                hidden = model(ids, mask).float()
                loss = ((hidden - target) ** 2).mean()
                if train:
                    loss.backward()
            torch.cuda.synchronize()
            grads = {n: p.grad.clone() for n, p in model.named_parameters()
                     if p.grad is not None}
            return (loss.item(), hidden.detach().reshape(b * l, -1), grads,
                    [fn.launches for fn in counters])

        n = cfg.num_hidden_layers
        fwd_k, h_k, _, launch_fk = run(models[0], False)
        loss_k, _, g_k, launch_k = run(models[0], True)
        loss_p, h_p, g_p, launch_p = run(models[1], True)
        fwd_rel = abs(fwd_k - loss_p) / abs(loss_p)
        fwd_cos = torch.nn.functional.cosine_similarity(
            h_k.double(), h_p.double(), dim=-1).min().item()
        rel = abs(loss_k - loss_p) / abs(loss_p)
        cos = grad_cosines(g_k, g_p)
        worst = min(cos, key=cos.get)
        log(f"C-4, tiny Qwen3 at head_dim {hd} ({cfg.num_attention_heads}/"
            f"{cfg.num_key_value_heads} heads, {n} layers), B={b} L={l}, row "
            f"lengths {list(lengths)}, bf16: K1 forward vs plain loss rel "
            f"{fwd_rel:.2e}, min row cosine {fwd_cos:.6f}; flash-VJP step "
            f"loss rel {rel:.2e} (tol {STEP_LOSS_REL:g}); {len(cos)} "
            f"gradients, min cosine {cos[worst]:.6f} ({worst}; tol "
            f"{STEP_GRAD_COS}); launches (K1, B7b dq, B7b dk/dv): forward "
            f"{launch_fk}, training {launch_k}, plain {launch_p}")
        if not (fwd_rel <= STEP_LOSS_REL and rel <= STEP_LOSS_REL
                and fwd_cos >= STEP_GRAD_COS and cos[worst] >= STEP_GRAD_COS
                and len(cos) == len(list(models[0].parameters()))):
            raise AssertionError(f"C-4: the kernels at head_dim {hd} disagree "
                                 "with the plain attention path")
        if (launch_fk, launch_k, launch_p) != ([n, 0, 0], [n, n, n],
                                               [0, 0, 0]):
            raise AssertionError(f"C-4 launches at head_dim {hd}: {launch_fk}"
                                 f" / {launch_k} / {launch_p}")
        del models


# -- phase 3a (C-4/C-5): head dims above 256, the chunked form ----------------


def sdpa_backend(q, k, v, mask) -> str:
    """The backend ``scaled_dot_product_attention`` picks for these inputs,
    by torch's own choice function."""
    from torch.nn.attention import SDPBackend

    try:
        return SDPBackend(torch._fused_sdp_choice(q, k, v, mask, 0.0,
                                                  False)).name
    except Exception as exc:  # a torch without the choice function
        return f"not read ({type(exc).__name__})"


def sdpa_time(fn, iters: int = 10):
    """SDPA's time, or None where it does not take the shape."""
    try:
        return time_ms(fn, iters=iters)
    except RuntimeError as exc:
        log(f"  scaled_dot_product_attention refuses the shape: {exc}"[:300])
        return None


def chunked_forms(hd: int, dtype) -> dict:
    """The form each chunked kernel takes at ``hd`` (above 256) in
    ``dtype``: bf16 on tensor cores up to 5 chunks of 256 in the forward, 2
    in the backward over rows (B7b's dq, B14 / B14p) and 4 over keys (B7b's
    dk / dv, ``chunk_bwd_keys_tc``); above those in a thread-block cluster
    up to 8 chunks in the forward and over rows
    (``csrc/flash_chunked_cluster.cuh``); fp32 in the 3xTF32 cluster form
    ("cluster_tf32", the same file) up to 8 chunks in the forward and over
    rows; the scalar form above and for fp32 dk / dv."""
    chunks = -(-hd // 256)
    if dtype != torch.bfloat16:
        tf32 = "cluster_tf32" if chunks <= 8 else "scalar"
        return {"fwd": tf32, "rows": tf32, "keys": "scalar"}
    return {kind: "tensor_cores" if chunks <= most else
            "cluster" if chunks <= cluster else "scalar"
            for kind, most, cluster in (("fwd", 5, 8), ("rows", 2, 8),
                                        ("keys", 4, 4))}


def wide_causal(gen, hd: int, dtype) -> dict:
    """K1 (both forms) and B7b at head dim ``hd`` (WIDE_CAUSAL's shape)
    against their plain versions with phase 3's gates, repeats identical;
    driven once through ``flash_causal_attention_train`` and
    ``torch.autograd.grad`` (counted, each kernel in the form
    ``chunked_forms`` names, its gradients equal to the kernels' bits);
    timed against the plain versions, the bounds and SDPA."""
    from unirec_tpu_torch.ops import flash_causal as fc

    b, l, hq, hkv = (WIDE_CAUSAL[x] for x in ("B", "L", "HQ", "HKV"))
    lengths = WIDE_CAUSAL["LENGTHS"]
    q, k, v, do, mask = causal_inputs(gen, b, l, hq, hkv, hd, dtype, lengths)
    where = f"C-4, hd {hd}, B={b} L={l} Hq={hq} Hkv={hkv}, lengths {lengths}"
    check_k1(*k1_error(q, k, v, mask, hq, hkv), dtype, where)
    check_repeat(f"K1 hd {hd} {dtype}",
                 [fc.flash_causal_attention(q, k, v, mask, hq, hkv)],
                 [fc.flash_causal_attention(q, k, v, mask, hq, hkv)])
    log(f"B7b {where}:")
    errs, args = b7b_errors(q, k, v, do, mask, hq, hkv, hd)
    counters = (fc.flash_causal_attention, fc.flash_causal_bwd_dq,
                fc.flash_causal_bwd_dkv)
    for fn in counters:
        fn.launches = 0
        fn.forms.clear()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    grads = torch.autograd.grad(
        fc.flash_causal_attention_train(*leaves, mask, hq, hkv), leaves, do)
    torch.cuda.synchronize()
    launches = [fn.launches for fn in counters]
    if launches != [1, 1, 1]:
        raise AssertionError(f"K1 / B7b hd {hd} launches {launches}")
    want = chunked_forms(hd, dtype)
    forms = dict(zip(("k1", "dq", "dkv"), (want["fwd"], want["rows"],
                                            want["keys"])))
    ran = [dict(fn.forms) for fn in counters]
    if ran != [{f: 1} for f in forms.values()]:
        raise AssertionError(f"K1 / B7b hd {hd} {dtype} ran the forms {ran},"
                             f" want {forms}")
    if not (torch.equal(grads[0], fc.flash_causal_bwd_dq(*args)) and all(
            torch.equal(g, r) for g, r in zip(
                grads[1:], fc.flash_causal_bwd_dkv(*args)))):
        raise AssertionError(f"K1 / B7b hd {hd}: the autograd path's "
                             "gradients are not the kernels'")
    del leaves, grads
    pairs = causal_pairs(mask)
    k1 = time_ms(lambda: fc.flash_causal_attention(
        q, k, v, mask, hq, hkv, mask_checked=True), iters=10)
    k1_plain = time_ms(lambda: fc.flash_causal_attention_plain(
        q, k, v, mask, hq, hkv), iters=3, warmup=1)
    dq = time_ms(lambda: fc.flash_causal_bwd_dq(*args), iters=10)
    dkv = time_ms(lambda: fc.flash_causal_bwd_dkv(*args), iters=10)
    bwd_plain = time_ms(lambda: fc.flash_causal_attention_bwd_plain(*args),
                        iters=3, warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh, allowed = sdpa_inputs(q, k, v, mask, hq, hkv)
    backend = sdpa_backend(qh, kh, vh, allowed)
    lib = sdpa_time(lambda: sdpa(qh, kh, vh, attn_mask=allowed))
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (qh, kh, vh))
    doh = do.reshape(b, l, hq, hd).transpose(1, 2)
    lib_fb = sdpa_time(lambda: torch.autograd.grad(
        sdpa(qg, kg, vg, attn_mask=allowed), (qg, kg, vg), doh))
    size = q.element_size()
    stats = 3 * 4 * b * l * hq + 4 * b * l
    bq, bkv = size * b * l * hq * hd, size * b * l * hkv * hd
    kv_read = 2 * bkv * float(mask.sum()) / mask.numel()
    b_k1 = bound(k1_bytes(q, k, v, mask), 2 * 2 * hd * pairs * hq,
                 ops_kind(dtype, forms["k1"]))
    b_dq = bound(3 * bq + kv_read + stats, 3 * 2 * hd * pairs * hq,
                 ops_kind(dtype, forms["dq"]))
    b_dkv = bound(2 * bq + kv_read + 2 * bkv + stats,
                  4 * 2 * hd * pairs * hq, ops_kind(dtype, forms["dkv"]))
    log(f"K1 / B7b chunked time {dtype} {where}: K1 {k1:.4f} ms (plain "
        f"{k1_plain:.4f}, bound {b_k1[0]:.4f} {b_k1[1]}), dq {dq:.4f} ms "
        f"(bound {b_dq[0]:.4f} {b_dq[1]}), dk/dv {dkv:.4f} ms (bound "
        f"{b_dkv[0]:.4f} {b_dkv[1]}), plain backward {bwd_plain:.4f} ms; "
        f"scaled_dot_product_attention ({backend}) forward "
        f"{'refused' if lib is None else f'{lib:.4f} ms'}, forward + backward "
        f"{'refused' if lib_fb is None else f'{lib_fb:.4f} ms'}; B7b's "
        f"backward (dq + dk/dv) {dq + dkv:.4f} ms; forms {forms}")
    del qh, kh, vh, qg, kg, vg
    torch.cuda.empty_cache()
    return {"errs": errs, "launches": launches, "sdpa_backend": backend,
            "forms": forms,
            "k1": dict(ms=k1, plain_ms=k1_plain, library_ms=lib,
                       bound_ms=b_k1[0], bound_by=b_k1[1]),
            "dq": dict(ms=dq, plain_ms=bwd_plain, library_ms=lib_fb,
                       bound_ms=b_dq[0], bound_by=b_dq[1]),
            "dkv": dict(ms=dkv, plain_ms=bwd_plain, library_ms=lib_fb,
                        bound_ms=b_dkv[0], bound_by=b_dkv[1])}


def wide_b14p(gen, dtype, res, b=WIDE_CROSS["B"], h=WIDE_CROSS["H"],
              hd=WIDE_CROSS["HD"]) -> None:
    """B14p at WIDE_CROSS's shape (``b`` users, ``h`` heads of ``hd``) in
    per-head layout, as ``phase_b14p``
    holds it: driven through ``flash_cross_attention_vjp`` and
    ``torch.autograd.grad`` (counted: one launch each way), against the
    plain path; the kernels against their plain versions, repeats
    identical, masked keys' zero dk / dv, the masked user's uniform
    average; timed beside the plain versions, the bounds and SDPA."""
    from unirec_tpu_torch.ops import attention as pa
    from unirec_tpu_torch.ops import flash_vjp as fl

    lkv, lq = WIDE_CROSS["LKV"], 64
    where = f"{dtype} B={b} H={h} Lq={lq} Lkv={lkv} hd={hd}"
    q, k, v, do, bias = b14p_inputs(gen, b, h, lq, lkv, hd, dtype)
    bias32 = pa.key_bias(bias, b, lkv, q.device)
    fl.flash_cross_vjp_fwd.launches = fl.flash_cross_vjp_bwd.launches = 0
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fl.flash_cross_attention_vjp(*leaves, bias)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    launches = (fl.flash_cross_vjp_fwd.launches,
                fl.flash_cross_vjp_bwd.launches)
    if launches != (1, 1):
        raise AssertionError(f"B14p {where}: launches {launches}")
    for key, n in zip(("b14p_fwd", "b14p_bwd"), launches):
        res[key]["launches"] = res[key].get("launches", 0) + n
    o32, m, l = fl.flash_cross_vjp_fwd_plain(q, k, v, bias32)
    dsum = (do.float() * o32).sum(-1).transpose(1, 2).contiguous()
    plain = fl.flash_cross_vjp_bwd_plain(q, k, v, bias32, do, m, l, dsum)
    res["b14p_fwd"]["err"] = max(res["b14p_fwd"]["err"], kernel_error(
        "B14P out (autograd)", out.detach(), o32.to(dtype), where))
    for name, g, r in zip("qkv", grads, plain):
        res["b14p_bwd"]["err"] = max(res["b14p_bwd"]["err"], kernel_error(
            f"B14P d{name} (autograd)", g, r, where,
            noise_floor=GRAD_NOISE_FLOOR if name in "qk" else 0.0))
    del leaves, out, grads
    state = {}
    runs = {
        "b14p_fwd": (lambda: fl.flash_cross_vjp_fwd(q, k, v, bias32),
                     lambda: fl.flash_cross_vjp_fwd_plain(q, k, v, bias32),
                     ("o", "m", "l")),
        "b14p_bwd": (lambda: fl.flash_cross_vjp_bwd(q, k, v, bias32, do,
                                                    *state["mld"]),
                     lambda: fl.flash_cross_vjp_bwd_plain(q, k, v, bias32, do,
                                                          *state["mld"]),
                     ("dq", "dk", "dv")),
    }
    for name, (kern, plain_fn, outs) in runs.items():
        got = kern()
        torch.cuda.synchronize()
        check_outputs(name.upper(), outs, got, plain_fn(), where, res[name],
                      rows32=dtype == torch.float32 and hd > 256)
        if not all(torch.equal(x, y) for x, y in zip(got, kern())):
            raise AssertionError(f"{name.upper()} {where}: a repeat gave "
                                 "other bits")
        if name == "b14p_fwd":
            kernel_error("B14P fully masked user", got[0][1],
                         v[1].float().mean(1, keepdim=True).expand(h, lq, hd),
                         where)
            state["mld"] = (got[1], got[2], (do.float() * got[0]).sum(
                -1).transpose(1, 2).contiguous())
        else:
            masked = bias32 != 0
            masked[1] = False
            if not all(bool((g.transpose(1, 2)[masked] == 0).all())
                       for g in got[1:]):
                raise AssertionError(f"B14P {where}: masked keys got a "
                                     "gradient")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = bias.to(dtype)
    res["sdpa_backend"] = sdpa_backend(q, k, v, mask)
    library = {"b14p_fwd": lambda: sdpa(q, k, v, attn_mask=mask),
               "b14p_bwd": sdpa_fwd_bwd(sdpa, q, k, v, mask, do)}
    bounds = flash_bounds(b, lq, lkv, q.element_size(), h)
    time_runs(runs, library, {"b14p_fwd": bounds["b14_fwd"],
                              "b14p_bwd": bounds["b14_bwd"]}, res, where)
    log(f"B14p {where}: the kernels repeat bit for bit, masked keys get "
        f"exactly zero dk / dv; SDPA's backend {res['sdpa_backend']}")


def wide_one_head(gen) -> dict:
    """C-19 on the card: bf16 at chunk counts the tensor-core backward does
    not hold.  B13, B14 and B14p at WIDE_CROSS's users and memory in one
    head of WIDE_ONE_HEAD_HD (four chunks: the forward on tensor cores, the
    one-pass backward in the cluster form), held to their plain versions as
    ``check_flash_cross`` and ``wide_b14p`` hold them, the forms counted,
    timed beside the bounds and SDPA; B13 at one head of WIDE_B13_HD (six
    chunks, the cluster forward), held, repeated and timed with the key
    splits of ``chunked_plan`` and without (``ms_unsplit``); then
    ``wide_scalar``."""
    from unirec_tpu_torch.ops import attention as pa
    from unirec_tpu_torch.ops import flash_vjp as fl

    sdpa = torch.nn.functional.scaled_dot_product_attention
    b16 = torch.bfloat16
    b, lkv, hd = WIDE_CROSS["B"], WIDE_CROSS["LKV"], WIDE_ONE_HEAD_HD
    where = f"{b16} B={b} Lq=64 Lkv={lkv} H=1 hd={hd}"
    want = chunked_forms(hd, b16)
    if (want["fwd"], want["rows"]) != ("tensor_cores", "cluster"):
        raise AssertionError(f"the chunked forms at hd {hd}: {want}")
    counters = (pa.launch_flash_cross_fwd, fl.launch_flash_cross_bwd)
    for fn in counters:
        fn.forms.clear()
    res = {n: {"err": 0.0} for n in ("b13", "b14_fwd", "b14_bwd", "b14p_fwd",
                                     "b14p_bwd")}
    c = check_flash_cross(gen, b16, b, lkv, 1, hd, res)
    mask = c["bias"].to(b16)
    qh, kh, vh = c["qh"], c["kh"], c["vh"]
    res["sdpa_backend"] = sdpa_backend(qh, kh, vh, mask)
    library = {"b13": lambda: sdpa(qh, kh, vh, attn_mask=mask),
               "b14_fwd": lambda: sdpa(qh, kh, vh, attn_mask=mask),
               "b14_bwd": sdpa_fwd_bwd(sdpa, qh, kh, vh, mask,
                                       pa.split_heads(c["do"], 1))}
    time_runs(c["runs"], library, flash_bounds(b, 64, lkv, 2, 1), res,
              f"{where} (SDPA backend {res['sdpa_backend']})")
    del c, qh, kh, vh, library
    torch.cuda.empty_cache()
    wide_b14p(gen, b16, res, h=1, hd=hd)
    ran = [set(fn.forms) for fn in counters]  # every launch of B13 / B14 / B14p
    if ran != [{want["fwd"]}, {want["rows"]}]:
        raise AssertionError(f"B13 / B14 / B14p {where} ran the forms {ran}")
    res["forms"] = {"fwd": want["fwd"], "bwd": want["rows"]}

    # B13 at one head of WIDE_B13_HD: the cluster forward
    hd = WIDE_B13_HD
    where = f"{b16} B={b} Lq=64 Lkv={lkv} H=1 hd={hd}"
    q, k3, v3, _, bias = flash_inputs(gen, b, lkv, b16, hd)
    qh, kh, vh = (pa.split_heads(t, 1) for t in (q, k3, v3))
    pa.launch_flash_cross_fwd.forms.clear()
    pa.flash_cross_attention.launches = 0
    got = pa.flash_cross_attention(qh, kh, vh, bias)
    torch.cuda.synchronize()
    form = chunked_forms(hd, b16)["fwd"]
    if (form != "cluster" or dict(pa.launch_flash_cross_fwd.forms) != {form: 1}
            or pa.flash_cross_attention.launches != 1):
        raise AssertionError(f"B13 {where} ran "
                             f"{dict(pa.launch_flash_cross_fwd.forms)}")
    err = kernel_error("B13 o", got, pa.flash_cross_attention_plain(
        qh, kh, vh, bias), where)
    check_repeat(f"B13 {where}", [got],
                 [pa.flash_cross_attention(qh, kh, vh, bias)])
    kernel_error("B13 fully masked user", got[1], vh[1].float().mean(
        1, keepdim=True).expand(1, 64, hd), where)
    io_q, io_kv = 2 * b * 64 * hd, 2 * b * lkv * hd
    b_ms, b_by = bound(2 * io_q + 2 * io_kv + 4 * b * lkv,
                       2 * 2 * b * 64 * lkv * hd, "bf16")
    mask = bias.to(b16)
    splits = pa.chunked_plan(qh, pa.CHUNKED_FWD, b, 1, 64, lkv, hd,
                              form)[0]
    b13 = dict(err=err, form=form, bound_ms=b_ms, bound_by=b_by,
               splits=splits,
               ms=time_ms(lambda: pa.flash_cross_attention(qh, kh, vh, bias),
                          iters=10),
               plain_ms=time_ms(lambda: pa.flash_cross_attention_plain(
                   qh, kh, vh, bias), iters=3, warmup=1),
               library_ms=sdpa_time(lambda: sdpa(qh, kh, vh, attn_mask=mask)),
               sdpa_backend=sdpa_backend(qh, kh, vh, mask))
    split_plan = pa.chunked_fwd_splits
    pa.chunked_fwd_splits = lambda *a: 1  # the same launch without key splits
    try:
        unsplit = pa.flash_cross_attention(qh, kh, vh, bias)
        b13["ms_unsplit"] = time_ms(
            lambda: pa.flash_cross_attention(qh, kh, vh, bias), iters=10)
    finally:
        pa.chunked_fwd_splits = split_plan
    b13["err"] = max(err, kernel_error("B13 o (one split)", unsplit,
                                       pa.flash_cross_attention_plain(
                                           qh, kh, vh, bias), where))
    log(f"B13 time {where} ({form}, {splits} key splits): kernel "
        f"{b13['ms']:.4f} ms (one split {b13['ms_unsplit']:.4f} ms), plain "
        f"{b13['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"scaled_dot_product_attention ({b13['sdpa_backend']}) "
        + ("refused" if b13["library_ms"] is None
           else f"{b13['library_ms']:.4f} ms"))
    del q, k3, v3, qh, kh, vh, got, unsplit
    torch.cuda.empty_cache()
    return {"hd1024": res, "b13_hd1536": b13, "hd2304": wide_scalar(gen)}


def wide_scalar(gen) -> dict:
    """bf16 at WIDE_SCALAR_HD (9 chunks, above the cluster form's 8): one
    small launch each of B13, B14's forward and backward (2 users, 64
    queries over 64 keys, one head; ``check_flash_cross``), K1 and B7b's dq
    and dk / dv (``b7b_errors``: B 2, L 64, 2 / 1 heads), held to their
    plain versions and repeated for identical bits, each counted in the
    scalar form."""
    from unirec_tpu_torch.ops import attention as pa
    from unirec_tpu_torch.ops import flash_causal as fc
    from unirec_tpu_torch.ops import flash_vjp as fl

    b16, hd = torch.bfloat16, WIDE_SCALAR_HD
    want = chunked_forms(hd, b16)
    if set(want.values()) != {"scalar"}:
        raise AssertionError(f"the chunked forms at hd {hd}: {want}")
    counters = (pa.launch_flash_cross_fwd, fl.launch_flash_cross_bwd,
                fc.flash_causal_attention, fc.flash_causal_bwd_dq,
                fc.flash_causal_bwd_dkv)
    for fn in counters:
        fn.forms.clear()
    res = {n: {"err": 0.0} for n in ("b13", "b14_fwd", "b14_bwd")}
    check_flash_cross(gen, b16, 2, 64, 1, hd, res)
    q, k, v, do, mask = causal_inputs(gen, 2, 64, 2, 1, hd, b16, (64, 37))
    errs, _ = b7b_errors(q, k, v, do, mask, 2, 1, hd)
    torch.cuda.synchronize()
    ran = [set(fn.forms) for fn in counters]
    if ran != [{"scalar"}] * len(counters):
        raise AssertionError(f"bf16 at hd {hd} ran the forms {ran}")
    log(f"bf16 at hd {hd} (9 chunks): B13, B14, K1 and B7b in the scalar "
        f"form, held and repeated")
    return {"errs": {**{k: r["err"] for k, r in res.items()}, **errs},
            "forms": want}


def fp32_rows(name, got, ref, where) -> float:
    """A float32 chunked output against its plain version: max|d| within
    KERNEL_TOL (1e-5 of max|ref|) and per-row (last dim) cosine >=
    KERNEL_COS over the rows whose ref norm is at least GRAD_NOISE_FLOOR of
    the largest row's (rows of exact value 0, or sums of nearly cancelling
    terms, are held by max|d| alone); the (m, l) statistics (``stats``
    names) elementwise within 1e-5 relative.  Returns max|d|."""
    a, b = got.double(), ref.double()
    if not bool(torch.isfinite(a).all()):
        raise AssertionError(f"{name} {where}: non-finite values")
    err = (a - b).abs().max().item()
    if name.split()[-1] in ("m", "l"):
        rel = ((a - b).abs() / b.abs().clamp_min(1e-30)).max().item()
        log(f"{name} {where}: max rel {rel:.3e} (tol 1e-5)")
        if not rel <= 1e-5:
            raise AssertionError(f"{name} {where} disagrees")
        return err
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    rel = err / b.abs().max().item()
    norm = b.norm(dim=-1)
    live = norm >= GRAD_NOISE_FLOOR * norm.max()
    cos = torch.nn.functional.cosine_similarity(a[live], b[live],
                                                dim=-1).min().item()
    log(f"{name} {where}: max|d| {err:.3e}, rel {rel:.3e} (tol "
        f"{KERNEL_TOL[torch.float32]:g}), min row cosine {cos:.7f} over "
        f"{int(live.sum())} of {len(live)} rows (tol {KERNEL_COS})")
    if not (rel <= KERNEL_TOL[torch.float32] and cos >= KERNEL_COS):
        raise AssertionError(f"{name} {where} disagrees with its plain "
                             "version")
    return err


def wide_fp32(gen) -> dict:
    """fp32 at every chunk count of the 3xTF32 cluster form above 2 chunks
    and at 9 (WIDE_FP32_HDS): K1 and B7b at B 2, L 160, 2 / 1 heads over
    ragged rows (``b7b_errors``), then B13, B14 and B14p at 3 users, 64
    queries over 300 keys in one head (the forward's key splits; user 1
    masked whole), each held to its plain version at 1e-5 of max|ref| with
    row cosine >= 0.9999 (``fp32_rows``), repeated for identical bits, each
    wrapper's chunked form counted (``chunked_forms``: the cluster form up
    to 8 chunks, B7b's dk / dv and 9 chunks scalar).  Then B13 and B14
    (``check_flash_cross``) at WIDE_CROSS's 8 users over 1,600 keys in one
    head of each of WIDE_FP32_TIMED, held and timed beside the bounds and
    SDPA."""
    from unirec_tpu_torch.ops import attention as pa
    from unirec_tpu_torch.ops import flash_causal as fc
    from unirec_tpu_torch.ops import flash_vjp as fl

    f32 = torch.float32
    counters = {"fwd": (fc.flash_causal_attention, pa.launch_flash_cross_fwd),
                "rows": (fc.flash_causal_bwd_dq, fl.launch_flash_cross_bwd),
                "keys": (fc.flash_causal_bwd_dkv,)}
    errs = dict.fromkeys(("o", "dq", "b13", "b14_fwd", "b14_bwd", "b14p_fwd",
                          "b14p_bwd"), 0.0)
    forms = {}
    for hd in WIDE_FP32_HDS:
        want = chunked_forms(hd, f32)
        for fns in counters.values():
            for fn in fns:
                fn.forms.clear()
        q, k, v, do, mask = causal_inputs(gen, 2, 160, 2, 1, hd, f32,
                                          (160, 97))
        e, _ = b7b_errors(q, k, v, do, mask, 2, 1, hd)
        errs["o"], errs["dq"] = max(errs["o"], e["o"]), max(errs["dq"],
                                                            e["dq"])
        where = f"{f32} B=3 Lq=64 Lkv=300 H=1 hd={hd}"
        q, k3, v3, do, bias = flash_inputs(gen, 3, 300, f32, hd)
        qh, kh, vh, doh = (pa.split_heads(t, 1) for t in (q, k3, v3, do))
        bias32 = pa.key_bias(bias, 3, 300, q.device)

        def hold(key, names, run, plain):
            got = run()
            check_repeat(f"{key.upper()} {where}", got, run())
            for n, g, r in zip(names, got, plain(got)):
                errs[key] = max(errs[key], fp32_rows(
                    f"{key.upper()} {n}", g, r, where))
            return got

        hold("b13", ("o",), lambda: (pa.flash_cross_attention(
            qh, kh, vh, bias),), lambda _: (pa.flash_cross_attention_plain(
                qh, kh, vh, bias),))
        o, m, l = hold("b14_fwd", ("o", "m", "l"),
                       lambda: fl.flash_cross_fwd(q, k3, v3, bias32, 1),
                       lambda _: fl.flash_cross_fwd_plain(q, k3, v3, bias32,
                                                          1))
        dsum = fl.attention_dsum(do, o, 1).contiguous()
        hold("b14_bwd", ("dq", "dk", "dv"),
             lambda: fl.flash_cross_bwd(q, k3, v3, bias32, do, m, l, dsum, 1),
             lambda _: fl.flash_cross_bwd_plain(q, k3, v3, bias32, do, m, l,
                                                dsum, 1))
        qp, kp, vp, dop = (t.contiguous() for t in (qh, kh, vh, doh))
        op, mp, lp = hold("b14p_fwd", ("o", "m", "l"),
                          lambda: fl.flash_cross_vjp_fwd(qp, kp, vp, bias32),
                          lambda _: fl.flash_cross_vjp_fwd_plain(qp, kp, vp,
                                                                 bias32))
        dsum = (dop * op).sum(-1).transpose(1, 2).contiguous()
        hold("b14p_bwd", ("dq", "dk", "dv"),
             lambda: fl.flash_cross_vjp_bwd(qp, kp, vp, bias32, dop, mp, lp,
                                            dsum),
             lambda _: fl.flash_cross_vjp_bwd_plain(qp, kp, vp, bias32, dop,
                                                    mp, lp, dsum))
        torch.cuda.synchronize()
        ran = {kind: [set(fn.forms) for fn in fns]
               for kind, fns in counters.items()}
        if ran != {kind: [{want[kind]}] * len(fns)
                   for kind, fns in counters.items()}:
            raise AssertionError(f"fp32 at hd {hd} ran the forms {ran}, "
                                 f"want {want}")
        forms[hd] = want
        log(f"fp32 at hd {hd} ({-(-hd // 256)} chunks): K1, B7b, B13, B14 "
            f"and B14p held and repeated, forms {want}")
        del q, k, v, do, k3, v3, qp, kp, vp, dop
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, lkv = WIDE_CROSS["B"], WIDE_CROSS["LKV"]
    timed = {}
    for hd in WIDE_FP32_TIMED:
        res = {n: {"err": 0.0} for n in ("b13", "b14_fwd", "b14_bwd")}
        c = check_flash_cross(gen, f32, b, lkv, 1, hd, res)
        mask = c["bias"].to(f32)
        qh, kh, vh = c["qh"], c["kh"], c["vh"]
        res["sdpa_backend"] = sdpa_backend(qh, kh, vh, mask)
        library = {"b13": lambda: sdpa(qh, kh, vh, attn_mask=mask),
                   "b14_fwd": lambda: sdpa(qh, kh, vh, attn_mask=mask),
                   "b14_bwd": sdpa_fwd_bwd(sdpa, qh, kh, vh, mask,
                                           pa.split_heads(c["do"], 1))}
        time_runs(c["runs"], library, flash_bounds(b, 64, lkv, 4, 1, hd),
                  res, f"{f32} B={b} Lq=64 Lkv={lkv} H=1 hd={hd} (SDPA "
                  f"backend {res['sdpa_backend']})")
        timed[hd] = res
        del c, qh, kh, vh, library
        torch.cuda.empty_cache()
    return {"errs": errs, "forms": forms, "timed": timed}


def phase_wide_heads(gen) -> dict:
    """(a) C-4/C-5 on the card: the chunked form of K1 and B7b at
    WIDE_CAUSAL's shape, head dims 320 and 512 (``wide_causal``), and of
    B13, B14 and B14p at WIDE_CROSS's (8 users, 64 queries over 1,600
    memory rows, 2 heads of 512; ~15% masked keys and one user masked
    whole), fp32 and bf16: each held to its plain version with phase 3's
    gates and repeated for identical bits, timed against its bound and SDPA
    (naming SDPA's backend).  B13 and B14 also at 2 heads of 320, held; and
    B13, B14 and B14p at the user step's USER_BATCH users, held and timed:
    bf16 (``out["users"]``), and float32 (``out["users_fp32"]``, its
    3xTF32 cluster kernels unsplit, with fp32_rows' max|d| and row cosine
    and a repeat).  Last (C-19), K1 / B7b at hd WIDE_BF16_HD in
    bf16 and the cross kernels at one head of 1024 and 1536
    (``wide_one_head``, ``out["one_head"]``); then fp32 at every chunk
    count of the 3xTF32 cluster form (``wide_fp32``, ``out["fp32"]``)."""
    from unirec_tpu_torch.ops import attention as pa

    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {"causal": {(hd, dtype): wide_causal(gen, hd, dtype)
                      for hd in WIDE_HDS
                      for dtype in (torch.float32, torch.bfloat16)}}
    b, lkv, h, hd = (WIDE_CROSS[x] for x in ("B", "LKV", "H", "HD"))
    for dtype in (torch.float32, torch.bfloat16):
        res = {n: {"err": 0.0} for n in ("b13", "b14_fwd", "b14_bwd",
                                         "b14p_fwd", "b14p_bwd")}
        c = check_flash_cross(gen, dtype, b, lkv, h, hd, res)
        mask = c["bias"].to(dtype)
        qh, kh, vh = c["qh"], c["kh"], c["vh"]
        res["sdpa_backend"] = sdpa_backend(qh, kh, vh, mask)
        library = {"b13": lambda: sdpa(qh, kh, vh, attn_mask=mask),
                   "b14_fwd": lambda: sdpa(qh, kh, vh, attn_mask=mask),
                   "b14_bwd": sdpa_fwd_bwd(sdpa, qh, kh, vh, mask,
                                           c["do"].reshape(b, 64, h, hd)
                                           .transpose(1, 2))}
        time_runs(c["runs"], library,
                  flash_bounds(b, 64, lkv, qh.element_size(), h), res,
                  f"{dtype} B={b} Lq=64 Lkv={lkv} H={h} hd={hd} (SDPA "
                  f"backend {res['sdpa_backend']})")
        del c, qh, kh, vh
        torch.cuda.empty_cache()
        wide_b14p(gen, dtype, res)
        out[dtype] = res
        torch.cuda.empty_cache()
    # B13 / B14 at hd 320 (two chunks, zero-padded), held without timing;
    # then the bf16 rows at the user step's 64 users, timed
    for dtype in (torch.float32, torch.bfloat16):
        check_flash_cross(gen, dtype, b, lkv, h, 320, {
            n: {"err": 0.0} for n in ("b13", "b14_fwd", "b14_bwd")})
        torch.cuda.empty_cache()
    # B13, B14 and B14p at the user step's USER_BATCH users, held and timed:
    # bf16, and float32, whose grid there fills the card, so that the
    # 3xTF32 cluster kernels run unsplit (no merge, no dq sum), as in the
    # float32 2-head user step
    b16, users = torch.bfloat16, USER_BATCH
    gen32 = torch.Generator(device="cuda").manual_seed(SEED + 19)
    for dtype, g in ((b16, gen), (torch.float32, gen32)):
        if dtype == torch.float32:
            q1 = torch.zeros(1, device="cuda")
            plans = [pa.chunked_plan(q1, kind, users, h, 64, lkv, hd,
                                     chunked_forms(hd, dtype)[way])[0]
                     for kind, way in ((pa.CHUNKED_FWD, "fwd"),
                                       (pa.CHUNKED_ROWS, "rows"))]
            if plans != [1, 1]:
                raise AssertionError(f"float32 at {users} users: key splits "
                                     f"{plans}, want none")
            log(f"float32 B13 / B14 / B14p at {users} users, 2 heads of "
                f"{hd}: the cluster_tf32 forward and backward unsplit")
        res = {n: {"err": 0.0} for n in ("b13", "b14_fwd", "b14_bwd",
                                         "b14p_fwd", "b14p_bwd")}
        c = check_flash_cross(g, dtype, users, lkv, h, hd, res)
        mask = c["bias"].to(dtype)
        qh, kh, vh = c["qh"], c["kh"], c["vh"]
        res["sdpa_backend"] = sdpa_backend(qh, kh, vh, mask)
        library = {"b13": lambda: sdpa(qh, kh, vh, attn_mask=mask),
                   "b14_fwd": lambda: sdpa(qh, kh, vh, attn_mask=mask),
                   "b14_bwd": sdpa_fwd_bwd(sdpa, qh, kh, vh, mask,
                                           c["do"].reshape(users, 64, h, hd)
                                           .transpose(1, 2))}
        time_runs(c["runs"], library,
                  flash_bounds(users, 64, lkv, qh.element_size(), h), res,
                  f"{dtype} B={users} Lq=64 Lkv={lkv} H={h} hd={hd} (SDPA "
                  f"backend {res['sdpa_backend']})")
        del c, qh, kh, vh, library
        torch.cuda.empty_cache()
        wide_b14p(g, dtype, res, b=users)
        out["users" if dtype == b16 else "users_fp32"] = res
        torch.cuda.empty_cache()
    # C-19: K1 / B7b at hd 768 in bf16 (K1 and dk / dv on tensor cores, dq
    # in the scalar form), then the cross kernels at one head of 1024 and
    # B13 at 1536 (``wide_one_head``)
    out["causal"][(WIDE_BF16_HD, b16)] = wide_causal(gen, WIDE_BF16_HD, b16)
    if out["causal"][(WIDE_BF16_HD, b16)]["forms"]["dq"] != "cluster":
        raise AssertionError(f"B7b's dq at hd {WIDE_BF16_HD}: not the "
                             "cluster form")
    out["one_head"] = wide_one_head(gen)
    out["fp32"] = wide_fp32(gen)
    return out


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


def write_sweep_inputs(tmp: str):
    """The seed-0 ``ItemQFormerConfig()`` checkpoint (``tmp/ckpt``) and the
    9,000-item field cache (``tmp/cache``) of the sweep and the training
    phases; (cfg, model, fields, emb, masks, ids, the numpy generator that
    made the cache)."""
    from unirec_tpu_torch.configs import ItemQFormerConfig
    from unirec_tpu_torch.data.cache import FieldEmbeddingCache
    from unirec_tpu_torch.utils.checkpoint import save_checkpoint
    from unirec_tpu_torch.utils.weights import init_item_qformer

    cfg = ItemQFormerConfig()
    # zero-padded, so that sorting them (the train CLI's field order) keeps
    # the cache's order
    fields = [f"f{i:02d}" for i in range(cfg.num_fields)]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
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
    return cfg, model, fields, emb, masks, ids, rng


def phase_sweep(smi: str, tmp: str) -> dict:
    """The CLI sweep at full width, bf16 (B1-B3) and then int8 (B4-B6), over
    one seed-0 checkpoint directory and one 9,000-item cache, both written
    under ``tmp`` (the training phase reuses them)."""
    t0 = time.perf_counter()
    cfg, model, fields, emb, masks, ids, rng = write_sweep_inputs(tmp)
    n, f, dm = SWEEP_ITEMS, cfg.num_fields, cfg.field_embedding_dim
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
    from unirec_tpu_torch.data.cache import FieldEmbeddingCache
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


# -- phase 5b: the quality gates of unirec_tpu_torch/scripts --------------------

# C-18 (ROADMAP.md C): an int8 serving mode that misses the JAX gate (0.999
# against the fp32 oracle) on the kernel and on the plain path alike misses
# by the W8A8 forward's own error.  It is then held against the fp32 oracle
# at C18_FLOOR, a distance 1.2 times the gate's (on an H100 the kernels read
# int8_xla 0.998836 and int8_fused 0.998908, the plain path 0.998945 and
# 0.998934), so that a fault in code both paths share (the weight or the
# activation quantization) still fails; and the kernel path against the
# plain path at PLAIN_PATH_COS (read: >= 0.999817), so that a kernel fault
# hidden inside that margin fails too.
C18_FLOOR = 1 - 1.2 * (1 - 0.999)
PLAIN_PATH_COS = 0.9995

# B8's fp32 form (the W8A8 training forward of `train joint --int8-base` at
# float32 compute) against its plain version, bit for bit: at the int8-base
# convergence model's projections (batch 8 x L 96 = 768 rows: q, k|v, o,
# gate|up, down) and at the serving shape, where it is timed
QUALITY_B8_SHAPES = ((768, 64, 64), (768, 64, 32), (768, 64, 128),
                     (768, 128, 64), B8_SHAPES[0])


def quality_counters() -> dict:
    """The kernels the gates run: B1-B6 (the engines), K1 (every serving
    mode, the convergence runs' evaluations), B8 (int8_xla, int8_fused's
    o_proj, the int8-base run's fp32 forward), B9a and B9b (int8_fused)."""
    from unirec_tpu_torch.ops import fused_qformer_int8 as pq
    from unirec_tpu_torch.ops import fused_qformer_layer as fq
    from unirec_tpu_torch.ops.flash_causal import flash_causal_attention

    return {"b1": fq.fused_self_attention_block,
            "b2": fq.fused_cross_attention_block, "b3": fq.fused_ffn_block,
            "b4": pq.fused_self_attention_block_q,
            "b5": pq.fused_cross_attention_block_q,
            "b6": pq.fused_ffn_block_q, "k1": flash_causal_attention,
            **int8_launches()}


def quality_b8_fp32(gen) -> dict:
    """B8's fp32 form against its plain version at QUALITY_B8_SHAPES (and a
    repeat), timed at the serving shape beside its plain version and
    ``torch._int_mm`` for the product alone."""
    from unirec_tpu_torch.ops.fused_qformer_int8 import quantize_weight
    from unirec_tpu_torch.ops.int8_matmul import int8_linear, int8_linear_plain

    f32 = torch.float32
    out = {"err": 0.0}
    for rows, k, n in QUALITY_B8_SHAPES:
        x = torch.randn(rows, k, device="cuda", generator=gen)
        x[5] = 0.0  # a row below the absmax floor
        wq, ws = quantize_weight(torch.randn(n, k, device="cuda",
                                             generator=gen) * 0.03)
        got = int8_linear(x, wq, ws, out_dtype=f32)
        ref = int8_linear_plain(x, wq, ws, f32)
        err = (got - ref).abs().max().item()
        same = torch.equal(got, ref) and torch.equal(
            got, int8_linear(x, wq, ws, out_dtype=f32))
        log(f"B8 fp32 [{rows}, {k}] -> {n}: max|d| {err:.3e} "
            f"({'bit for bit' if same else 'DIFFERS'}, repeat included)")
        if not same:
            raise AssertionError("B8's fp32 form disagrees with its plain "
                                 f"version at [{rows}, {k}] -> {n}")
        out["err"] = max(out["err"], err)
    codes = torch.randint(-127, 128, (rows, k), device="cuda", generator=gen,
                          dtype=torch.int8)
    t_k = time_ms(lambda: int8_linear(x, wq, ws, out_dtype=f32), iters=20)
    t_p = time_ms(lambda: int8_linear_plain(x, wq, ws, f32), iters=5,
                  warmup=1)
    t_k2 = time_ms(lambda: int8_linear(x, wq, ws, out_dtype=f32), iters=20)
    t_l = time_ms(lambda: torch._int_mm(codes, wq.t()), iters=20)
    # x and the output in float32, the codes and their scales once
    b_ms, b_by = bound(4 * rows * k + n * k + 4 * n + 4 * rows * n,
                       2 * rows * k * n, "int8")
    log(f"B8 fp32 [{rows}, {k}] -> {n} time: kernel {t_k:.4f} / {t_k2:.4f} "
        f"ms, plain {t_p:.4f} ms, torch._int_mm (the product alone) "
        f"{t_l:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    out.update(ms=min(t_k, t_k2), plain_ms=t_p, library_ms=t_l,
               bound_ms=b_ms, bound_by=b_by)
    return out


@contextlib.contextmanager
def _plain_qwen3():
    """The Qwen3 forward's kernels (K1, B8, B9a, B9b) replaced by their
    plain versions, on the card, for ``phase_quality``: where a serving gate
    is missed, the same mode on the plain path says whether a kernel is at
    fault."""
    from unirec_tpu_torch.models import qwen3 as pq
    from unirec_tpu_torch.ops import fused_qwen3_int8 as pf
    from unirec_tpu_torch.ops.flash_causal import flash_causal_attention_plain
    from unirec_tpu_torch.ops.int8_matmul import int8_linear_plain

    def attention(q, k, v, mask, hq, hkv, mask_checked=False):
        return flash_causal_attention_plain(q, k, v, mask, hq, hkv)

    def ste(x, wq, ws):
        y = int8_linear_plain(x.reshape(-1, x.shape[-1]), wq, ws, x.dtype)
        return y.reshape(*x.shape[:-1], wq.shape[0])

    swaps = {"flash_causal_attention": attention, "int8_linear_ste": ste,
             "qkv_int8": pf.qkv_int8_plain,
             "swiglu_mlp_int8": pf.swiglu_mlp_int8_plain}
    saved = {name: getattr(pq, name) for name in swaps}
    try:
        for name, fn in swaps.items():
            setattr(pq, name, fn)
        yield
    finally:
        for name, fn in saved.items():
            setattr(pq, name, fn)


def phase_quality(smi: str) -> dict:
    """The gates of ``unirec_tpu_torch/scripts`` through their functions:
    the engine gate (``measure_int8_quality``: the bf16 and int8 engines at
    ``ItemQFormerConfig()``, batch 512, against the fp32 model, cos_min >=
    0.999), the serving gate (``measure_serving_quality``: ``Qwen3Config()``,
    seq 512, 64 users at batch 16, 2,000 items; bf16 >= 0.9995, int8_xla and
    int8_fused >= 0.999 against the fp32 oracle) and the ``--int8-base``
    convergence gate (``int8_base_convergence``: 800 steps each way,
    ``quality_gates.converge_verdict``); each kernel's launches, exact, and
    B8's fp32 form against its plain version.  A serving mode that misses
    its gate runs again on the plain path (``_plain_qwen3``): if that
    passes, the kernels fail the phase; if it misses too, the miss is the
    W8A8 forward's own (C-18), logged as FAIL with the error split between
    the attention's and the MLP's W8A8 projections, and the mode must hold
    the fp32 oracle at ``C18_FLOOR`` and the plain path at
    ``PLAIN_PATH_COS``.  Every reading is printed before a missed gate
    fails the phase."""
    from unirec_tpu_torch.configs import ItemQFormerConfig, LoRAConfig
    from unirec_tpu_torch.models.qwen3 import (
        quantize_qwen3_weights,
        set_qweights,
    )
    from unirec_tpu_torch.scripts import convergence_demo as demo
    from unirec_tpu_torch.scripts import int8_base_convergence as conv
    from unirec_tpu_torch.scripts import measure_int8_quality as mq
    from unirec_tpu_torch.scripts import measure_serving_quality as ms
    from unirec_tpu_torch.scripts import quality_gates as qg
    from unirec_tpu_torch.utils.weights import init_item_qformer, init_joint

    t_phase = time.perf_counter()
    log(f"quality gates on {smi}")
    counters = quality_counters()
    missed = []

    def reset():
        for fn in counters.values():
            fn.launches = 0

    def read() -> dict:
        return {k: fn.launches for k, fn in counters.items() if fn.launches}

    def expect(what: str, got: dict, want: dict) -> None:
        log(f"{what} launches: {json.dumps(got)}")
        if got != want:
            raise AssertionError(f"{what} launched {got}, expected {want}")

    # (a) the engines at ItemQFormerConfig(), batch 512
    t0 = time.perf_counter()
    cfg = ItemQFormerConfig()
    model = init_item_qformer(cfg, torch.Generator("cuda").manual_seed(0),
                              device="cuda")
    fields, mask = mq.make_inputs(cfg, mq.BATCH, "cuda", seed=1)
    reset()
    lines = [mq.quality_line(p, s)
             for p, s in mq.measure(model, cfg, fields, mask).items()]
    launches = {"engine": read()}
    for line in lines:
        log(line)
    ok, detail = qg.engine_verdict("\n".join(lines))
    log(f"[gate engine] {'PASS' if ok else 'FAIL'} "
        f"({time.perf_counter() - t0:.1f}s) {detail}")
    missed += [] if ok else ["engine"]
    n_layers = cfg.num_hidden_layers
    n_cross = sum(k.endswith("crossattention.query.weight")
                  for k in model.state_dict())
    expect("engine", launches["engine"],
           {"b1": n_layers, "b2": n_cross, "b3": n_layers, "b4": n_layers,
            "b5": n_cross, "b6": n_layers})
    del model, fields, mask
    gc.collect()
    torch.cuda.empty_cache()

    # (b) serving at Qwen3Config(), seq 512, 64 users at batch 16
    t0 = time.perf_counter()
    users, batch = 64, 16
    qwen, qf, jc = ms.configs(tiny=False)
    cache, catalog, item_dict, tok, hists = ms.serving_data(
        qwen, qf, jc, 2000, users)
    model32 = init_joint(qwen, qf, jc, LoRAConfig(),
                         torch.Generator("cuda").manual_seed(0),
                         device="cuda")
    reset()

    def after(label):
        launches[label] = read()
        reset()

    results = ms.encode_modes(model32, tok, item_dict, cache, catalog, hists,
                              batch, log=log, after=after)
    findings = []
    for line, passed in ms.gate_lines(results):
        log(line)
        if passed:
            continue
        # the same mode on the plain path locates the miss: where it passes,
        # the kernels are at fault; where it misses too, the miss is the
        # W8A8 forward's own on these weights (C-18)
        label = line.split(":")[0]
        with _plain_qwen3():
            plain = ms.encode(ms.bf16_model(model32), tok, item_dict, cache,
                              catalog, hists, batch, **ms.MODES[label])
        reset()
        cos = ms.user_cosines(plain, results["fp32"])
        log(f"{label} on the plain path: cosine mean {cos.mean():.6f} min "
            f"{cos.min():.6f} (gate {ms.GATES[label]})")
        if cos.min() >= ms.GATES[label]:
            missed.append(label)
            continue
        kern = ms.user_cosines(results[label], results["fp32"])
        held = ms.user_cosines(results[label], plain)
        ok = bool(kern.min() >= C18_FLOOR and held.min() >= PLAIN_PATH_COS)
        log(f"{label}: C-18, the JAX gate is missed on the plain path too; "
            f"held to the fp32 oracle at min {kern.min():.6f} (floor "
            f"{C18_FLOOR:.4f}) and to the plain path at min "
            f"{held.min():.6f} (gate {PLAIN_PATH_COS}) "
            f"{'OK' if ok else 'FAIL'}")
        findings.append(label)
        missed += [] if ok else [label]
    if "int8_xla" in findings:
        # int8_xla's error split by block: the attention's four W8A8
        # projections alone, then the MLP's three, the rest in bf16
        model_bf16 = ms.bf16_model(model32)
        qweights = quantize_qwen3_weights(model_bf16)
        for part in ("self_attn", "mlp"):
            model = model_bf16.clone()
            set_qweights(model, {k: v for k, v in qweights.items()
                                 if f".{part}." in k})
            cos = ms.user_cosines(
                ms.encode(model, tok, item_dict, cache, catalog, hists,
                          batch), results["fp32"])
            log(f"int8_xla, {part} only in W8A8: cosine mean "
                f"{cos.mean():.6f} min {cos.min():.6f}")
            del model
        del model_bf16, qweights
        reset()
    log(f"[gate serving] ({time.perf_counter() - t0:.1f}s)")
    per = qwen.num_hidden_layers * (users // batch)  # a layer's, 4 batches
    expect("serving fp32", launches["fp32"], {"k1": per})
    expect("serving bf16", launches["bf16"], {"k1": per})
    expect("serving int8_xla", launches["int8_xla"],
           {"k1": per, "b8": 7 * per})
    expect("serving int8_fused", launches["int8_fused"],
           {"k1": per, "b8": per, "b9a": per, "b9b": per})
    del model32, results
    gc.collect()
    torch.cuda.empty_cache()

    # (c) --int8-base convergence, 800 steps each way from one init
    t0 = time.perf_counter()
    corpus = demo.make_corpus()
    reset()
    j = conv.compare(*corpus[:4], device="cuda")
    launches["converge"] = read()
    log(json.dumps(j))
    ok, detail = qg.converge_verdict(j)
    log(f"[gate converge] {'PASS' if ok else 'FAIL'} "
        f"({time.perf_counter() - t0:.1f}s) {detail}")
    missed += [] if ok else ["converge"]
    # the int8 run's forward: 7 projections of each layer a step; each run's
    # evaluation: 2 batches of 16 over the 32 held-out users
    expect("converge", launches["converge"],
           {"b8": 7 * demo.LAYERS * j["steps"], "k1": 2 * 2 * demo.LAYERS})

    b8_fp32 = quality_b8_fp32(torch.Generator(device="cuda").manual_seed(
        SEED + 21))
    b8_fp32["launches"] = launches["converge"]["b8"]
    seconds = time.perf_counter() - t_phase
    log(f"phase_quality: {seconds:.1f} s; JAX serving gates missed on the "
        f"kernel and the plain path alike (C-18, held at {C18_FLOOR:.4f}): "
        f"{findings or 'none'}")
    if missed:
        raise AssertionError(f"quality gates missed: {missed}")
    return {"launches": launches, "b8_fp32": b8_fp32, "seconds": seconds}


# -- phase 5a: the pipeline's front end -------------------------------------------

# synthetic raw files for `data` (All_Beauty's shape), the text backend at
# the Qwen3-Embedding tower's serving shape (batch 64 x L 128: 16 and 8 heads
# of 128, 28 layers), the CLIP towers at ViT-L/14 (batch 32, 257 tokens) and
# the CLIP text tower (batch 128, L 77), `users` over phase 4's files
FRONT_ITEMS, FRONT_USERS = 2000, 1000
TEXT_ITEMS, TEXT_BATCH, TEXT_LEN = 512, 64, 128
VIT_BATCH, CLIP_TEXT_BATCH = 32, 128
USERS_N, USERS_BATCH = 256, 16
# the text backend's pooled rows on K1 against the same backend on the plain
# attention path, and users with the field cache on and off the device:
# row cosine; the CLIP towers in bf16 against fp32 on the same (bf16)
# weights: row cosine
TEXT_PLAIN_COS, USERS_COS, TOWER_COS = 0.999, 0.999, 0.99
FRONT_WORDS = ("serum lip balm cherry matte gloss travel size vitamin mask oil "
               "brush set mini rose hydrating cream face shampoo nail polish "
               "remover spf sunscreen eye liner palette glow").split()


def row_cosines(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                             * np.linalg.norm(b, axis=1))


def write_front_raw(root: str, rng) -> None:
    """meta.jsonl (FRONT_ITEMS items), reviews.jsonl and x.inter
    (FRONT_USERS users of 13-30 interactions), seeded.  Item texts are as
    long as All_Beauty's: title, feature bullets and description together
    pass the text tower's 128 tokens in most rows."""
    def words(lo, hi):
        return " ".join(rng.choice(FRONT_WORDS, rng.integers(lo, hi)))

    with open(os.path.join(root, "meta.jsonl"), "w") as fh:
        for i in range(FRONT_ITEMS):
            fh.write(json.dumps({
                "parent_asin": f"B{i:05d}", "title": words(8, 30),
                "main_category": "All Beauty", "store": f"store{i % 97}",
                "price": None if i % 11 == 0 else round(float(
                    rng.uniform(2, 80)), 2),
                "average_rating": round(float(rng.uniform(1, 5)), 1),
                "rating_number": int(rng.integers(0, 5000)),
                "description": [words(60, 200)] if i % 4 else [],
                "features": [words(6, 20) for _ in range(rng.integers(2, 6))]
                if i % 3 else [],
                "details": {"Brand": f"brand{i % 53}", "Color": words(1, 2),
                            "Size": f"{1 + i % 9} oz",
                            **({"Style": words(1, 3)} if i % 2 else {}),
                            **({"Material": words(1, 2)} if i % 5 == 0
                               else {})},
                "images": [{"variant": "MAIN",
                            "large": f"https://img.example/{i}.jpg"}],
            }) + "\n")
    inter_rows = []
    with open(os.path.join(root, "reviews.jsonl"), "w") as fh:
        for u in range(FRONT_USERS):
            items = rng.choice(FRONT_ITEMS, rng.integers(13, 31), replace=False)
            times = np.sort(rng.integers(10**9, 2 * 10**9, len(items)))
            for j, (i, t) in enumerate(zip(items, times)):
                inter_rows.append(f"user{u}\tB{i:05d}\t5.0\t{t}\n")
                if j < 3:
                    fh.write(json.dumps({
                        "user_id": f"user{u}", "parent_asin": f"B{i:05d}",
                        "title": words(1, 4), "text": words(5, 25),
                        "rating": 5.0, "timestamp": int(t)}) + "\n")
    with open(os.path.join(root, "x.inter"), "w") as fh:
        fh.write("user_id:token\titem_id:token\trating:float\t"
                 "timestamp:float\n")
        fh.writelines(inter_rows)


def front_data(root: str) -> dict:
    """``data`` through the port's CLI: the five subcommands over the raw
    files; counts checked."""
    from unirec_tpu_torch.cli import data_pipeline
    from unirec_tpu_torch.configs import DEFAULT_FIELD_MAPPING

    t0 = time.perf_counter()
    write_front_raw(root, np.random.default_rng(SEED + 16))
    raw_s = time.perf_counter() - t0

    def path(name):
        return os.path.join(root, name)

    t0 = time.perf_counter()
    for argv in (["item-dict", "--input", path("meta.jsonl"), "--output",
                  path("items.json")],
                 ["review-dict", "--input", path("reviews.jsonl"), "--output",
                  path("reviews.json")],
                 ["triplet-dict", "--input", path("items.json"), "--output",
                  path("triplet.json")],
                 ["rec-old-user", "--inter", path("x.inter"),
                  "--output-prefix", path("rec")],
                 ["rec-new-user", "--inter", path("x.inter"),
                  "--output-prefix", path("new")]):
        if data_pipeline.main(argv) != 0:
            raise AssertionError(f"data {argv[0]} failed")
    data_s = time.perf_counter() - t0
    counts = {}
    for name in ("items.json", "reviews.json", "triplet.json",
                 "rec_train.json", "rec_test.json", "new_train_LRanker.json",
                 "new_test_LRanker.json"):
        with open(path(name)) as fh:
            counts[name] = len(json.load(fh))
    log(f"front end, data: raw files ({FRONT_ITEMS} items, {FRONT_USERS} "
        f"users) written in {raw_s:.2f} s; item-dict, review-dict, "
        f"triplet-dict, rec-old-user, rec-new-user in {data_s:.2f} s: {counts}")
    want = {"items.json": FRONT_ITEMS, "reviews.json": 3 * FRONT_USERS,
            "triplet.json": FRONT_ITEMS, "rec_train.json": FRONT_USERS,
            "rec_test.json": FRONT_USERS, "new_train_LRanker.json": 232,
            "new_test_LRanker.json": 58}
    if counts != want:
        raise AssertionError(f"data outputs {counts}, want {want}")
    with open(path("triplet.json")) as fh:
        triplet = json.load(fh)
    if set(triplet["B00005"]) != set(DEFAULT_FIELD_MAPPING):
        raise AssertionError(f"triplet fields {sorted(triplet['B00005'])}")
    return triplet


def log_device_split(smi: str, what: str, fn, top: int = 6) -> None:
    """One call of ``fn`` under torch.profiler: its device time by kernel
    (the top ``top``) beside its host time, and the device's idle share."""
    fn()
    torch.cuda.synchronize()
    with torch.inference_mode(), torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = device_time_by_kernel(prof)
    total = sum(t for _, t in rows)
    log(f"[{smi}] {what} under torch.profiler: {total:.2f} ms of device time "
        f"in {len(rows)} kernels of a {wall:.2f} ms call (idle "
        f"{100 * max(0.0, 1 - total / wall):.1f}%)"
        + ("" if rows else " (no device rows: breakdown not measured)"))
    for name, t in rows[:top]:
        log(f"  {t:9.3f} ms {100 * t / total:5.1f}%  {name[:110]}")


def front_text_backend(smi: str, triplet: dict) -> dict:
    """The full-width Qwen3-Embedding text backend on TEXT_ITEMS item texts:
    K1 launches (28 a batch), the pooled rows against the backend on the
    plain attention path, K1 on layer 0's q, k, v against its plain version,
    texts/s, and K1's time at the tower's shape beside SDPA's and its
    bound."""
    from unirec_tpu_torch.cli.candidate_embeddings import extract_text
    from unirec_tpu_torch.configs import Qwen3Config
    from unirec_tpu_torch.encoders.backends import Qwen3TextBackend
    from unirec_tpu_torch.models import qwen3 as qwen3_mod
    from unirec_tpu_torch.ops import flash_causal as fc

    cfg = Qwen3Config()
    t0 = time.perf_counter()
    backend = Qwen3TextBackend(cfg, max_length=TEXT_LEN,
                               batch_size=TEXT_BATCH, device="cuda",
                               seed=SEED)
    build_s = time.perf_counter() - t0
    texts = [extract_text(item) for item in list(triplet.values())[:TEXT_ITEMS]]
    backend.encode(texts[:TEXT_BATCH])  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    fc.flash_causal_attention.launches = 0
    t0 = time.perf_counter()
    rows = backend.encode(texts)
    encode_s = time.perf_counter() - t0
    launches = fc.flash_causal_attention.launches
    batches = -(-len(texts) // TEXT_BATCH)
    want = batches * cfg.num_hidden_layers

    def plain_attention(q, k, v, mask, hq, hkv, mask_checked=False):
        return fc.flash_causal_attention_plain(q, k, v, mask, hq, hkv)

    qwen3_mod.flash_causal_attention = plain_attention
    try:
        plain_rows = backend.encode(texts)
    finally:
        qwen3_mod.flash_causal_attention = fc.flash_causal_attention
    cos = row_cosines(rows, plain_rows)
    norms = np.linalg.norm(rows, axis=1)
    ids, masks = backend.tokenize(texts[:TEXT_BATCH])  # no empty text
    fwd_ms = time_ms(lambda: backend.forward(ids, masks), iters=10, warmup=2)
    log_device_split(smi, f"text tower bf16 batch {TEXT_BATCH}",
                     lambda: backend.forward(ids, masks))
    lengths = masks.sum(1)
    log(f"[{smi}] front end, Qwen3TextBackend(Qwen3Config()) {cfg.num_hidden_layers} "
        f"layers x {cfg.hidden_size}, bf16, max_length {TEXT_LEN}, batch "
        f"{TEXT_BATCH} (seed-{SEED} weights, built in {build_s:.1f} s): "
        f"{len(texts)} item texts ({int(lengths.min())}-{int(lengths.max())} "
        f"tokens, mean {lengths.mean():.1f}, fill {lengths.mean() / TEXT_LEN:.4f}"
        f" in the first batch) encoded in "
        f"{encode_s:.3f} s = {len(texts) / encode_s:.1f} texts/s with hash "
        f"tokenization; forward of one tokenized batch {fwd_ms:.2f} ms = "
        f"{TEXT_BATCH / fwd_ms * 1e3:.1f} texts/s; K1 launches {launches} "
        f"(want {want}: {cfg.num_hidden_layers} a batch x {batches}); pooled "
        f"rows vs the plain attention path: min row cosine {cos.min():.6f} "
        f"(tol {TEXT_PLAIN_COS}), norms {norms.min():.6f}-{norms.max():.6f}")
    if launches != want:
        raise AssertionError(f"text backend K1 launches {launches}, want {want}")
    if not (np.isfinite(rows).all() and rows.shape == (len(texts),
                                                       cfg.hidden_size)):
        raise AssertionError("text backend rows not finite or misshapen")
    if not cos.min() >= TEXT_PLAIN_COS or abs(norms - 1).max() > 1e-3:
        raise AssertionError("text backend rows disagree with the plain path")

    # K1 at the tower's shape, on layer 0's q, k and v of the first batch
    from unirec_tpu_torch.models.qwen3 import rotary_embedding

    model = backend.model
    hq, hkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim)
    with torch.inference_mode():
        ids_t = torch.from_numpy(ids).cuda().long()
        mask = torch.from_numpy(masks).cuda()
        b, l = ids_t.shape
        pos = torch.arange(l, device="cuda")[None].expand(b, l)
        rc, rs = rotary_embedding(pos, hd, cfg.rope_theta, dtype=model.dtype)
        layer = model.layers[0]
        q, k, v = layer.self_attn.qkv(
            layer.input_layernorm(model.embed(ids_t)), rc, rs)
        err, ref_max = k1_error(q, k, v, mask, hq, hkv)
        check_k1(err, ref_max, torch.bfloat16, "text tower layer 0")
        kern = time_ms(lambda: fc.flash_causal_attention(
            q, k, v, mask, hq, hkv, mask_checked=True))
        plain = time_ms(lambda: fc.flash_causal_attention_plain(
            q, k, v, mask, hq, hkv))
        kern2 = time_ms(lambda: fc.flash_causal_attention(
            q, k, v, mask, hq, hkv, mask_checked=True))
        qh, kh, vh, allowed = sdpa_inputs(q, k, v, mask, hq, hkv)
        lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=allowed))
    pairs = causal_pairs(mask)
    fill = float(mask.sum()) / mask.numel()
    b_ms, b_by = bound(k1_bytes(q, k, v, mask), 2 * 2 * hd * pairs * hq,
                       "bf16")
    log(f"[{smi}] K1 at the text tower's shape B={b} L={l} Hq={hq} Hkv={hkv} "
        f"hd={hd} bf16 (fill {fill:.4f}: valid tokens / B*L; {pairs} causal "
        f"pairs of the batch's lengths): kernel "
        f"{kern:.4f} / {kern2:.4f} ms, plain {plain:.4f} ms, "
        f"scaled_dot_product_attention {lib:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by})")
    del backend, model
    return {"launches": launches, "err": err, "ms": min(kern, kern2),
            "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
            "bound_by": b_by, "fill": fill}


def front_clip_towers(smi: str, gen) -> None:
    """The CLIP ViT-L/14 vision tower and the CLIP text tower, through their
    backends' forwards in bf16 (seed-0 weights) against the same weights in
    fp32: row cosine, images/s and texts/s.  The card has no PIL or
    transformers: pixels and ids are seeded arrays."""
    from unirec_tpu_torch.encoders.backends import (
        CLIPImageBackend,
        CLIPTextBackend,
    )
    from unirec_tpu_torch.models.clip import CLIPTextTower, CLIPVisionTower

    vision = CLIPImageBackend(device="cuda", seed=SEED)  # bf16
    vc = vision.config
    v32 = CLIPVisionTower(vc, device="cuda").eval()
    v32.load_state_dict(vision.model.state_dict())
    pix = torch.randn(VIT_BATCH, vc.image_size, vc.image_size, 3,
                      device="cuda", generator=gen)
    emb16 = vision.forward(pix.cpu().numpy())
    with torch.inference_mode():
        emb32 = v32(pix).cpu().numpy()
        ms16 = time_ms(lambda: vision.model(pix), iters=10, warmup=2)
        ms32 = time_ms(lambda: v32(pix), iters=3, warmup=1)
    cos_v = row_cosines(emb16, emb32)
    log_device_split(smi, f"ViT-L/14 bf16 batch {VIT_BATCH}",
                     lambda: vision.model(pix))
    n_params = sum(p.numel() for p in vision.model.parameters())
    log(f"[{smi}] front end, CLIP vision tower ViT-L/14 "
        f"({vc.num_hidden_layers} x {vc.hidden_size}, {vc.num_patches + 1} "
        f"tokens, {n_params} parameters), batch {VIT_BATCH}: bf16 {ms16:.2f} "
        f"ms = {VIT_BATCH / ms16 * 1e3:.1f} images/s, fp32 {ms32:.2f} ms = "
        f"{VIT_BATCH / ms32 * 1e3:.1f} images/s; bf16 vs fp32 row cosine min "
        f"{cos_v.min():.6f} mean {cos_v.mean():.6f} (tol {TOWER_COS})")
    if not (np.isfinite(emb16).all() and cos_v.min() >= TOWER_COS):
        raise AssertionError("the bf16 vision tower disagrees with fp32")
    del vision, v32

    text = CLIPTextBackend(dtype=torch.bfloat16, device="cuda", seed=SEED)
    tc = text.config
    t32 = CLIPTextTower(tc, device="cuda").eval()
    t32.load_state_dict(text.model.state_dict())
    b, l = CLIP_TEXT_BATCH, tc.max_position_embeddings
    ids = torch.randint(1, tc.eos_token_id - 1, (b, l), device="cuda",
                        generator=gen)
    eos = torch.randint(2, l, (b,), device="cuda", generator=gen)
    cols = torch.arange(l, device="cuda")[None]
    ids = torch.where(cols >= eos[:, None], tc.eos_token_id, ids)
    ids[:, 0] = tc.eos_token_id - 1  # start of text
    mask = (cols <= eos[:, None]).float()
    emb16 = text.forward(ids.cpu().numpy(), mask.cpu().numpy())
    with torch.inference_mode():
        emb32 = t32(ids, mask).cpu().numpy()
        ms16 = time_ms(lambda: text.model(ids, mask), iters=10, warmup=2)
    cos_t = row_cosines(emb16, emb32)
    log(f"[{smi}] front end, CLIP text tower ({tc.num_hidden_layers} x "
        f"{tc.hidden_size}, L {l}), batch {b}: bf16 {ms16:.2f} ms = "
        f"{b / ms16 * 1e3:.1f} texts/s; bf16 vs fp32 row cosine min "
        f"{cos_t.min():.6f} mean {cos_t.mean():.6f} (tol {TOWER_COS})")
    if not (np.isfinite(emb16).all() and cos_t.min() >= TOWER_COS):
        raise AssertionError("the bf16 CLIP text tower disagrees with fp32")


def front_tokens(smi: str, tmp: str, root: str, n_items: int) -> None:
    """``tokens --data`` at batch SWEEP_BATCH over phase 5's checkpoint,
    saved again with the default schema's fields: the raw triplet dict
    encoded by ``ItemEncoder()`` (hash text and image, MWNE on the card),
    then swept through B1-B3 (launch counts checked)."""
    from unirec_tpu_torch.cli.generate_all_item_embeddings import main as cli
    from unirec_tpu_torch.configs import DEFAULT_FIELD_MAPPING
    from unirec_tpu_torch.data.cache import FieldEmbeddingCache
    from unirec_tpu_torch.inference.qformer_inference import QFormerInference
    from unirec_tpu_torch.ops import fused_qformer_layer as fq
    from unirec_tpu_torch.utils.checkpoint import save_checkpoint

    cfg, state, _ = QFormerInference.read_checkpoint(os.path.join(tmp, "ckpt"))
    fields = sorted(DEFAULT_FIELD_MAPPING)
    ckpt = os.path.join(tmp, "ckpt_schema")
    save_checkpoint(ckpt, state, cfg, extra={"field_names": fields})
    out, prog = os.path.join(tmp, "front_tokens.pkl"), os.path.join(
        tmp, "front_progress.json")
    blocks = (fq.fused_self_attention_block, fq.fused_cross_attention_block,
              fq.fused_ffn_block)
    for fn in blocks:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli(["--checkpoint", ckpt, "--data", os.path.join(root,
                                                           "triplet.json"),
              "--cache-dir", os.path.join(tmp, "front_cache"),
              "--batch-size", str(SWEEP_BATCH), "--output", out,
              "--progress-file", prog])
    cli_s = time.perf_counter() - t0
    launches = [fn.launches for fn in blocks]
    batches = -(-n_items // SWEEP_BATCH)
    n_cross = len(range(0, cfg.num_hidden_layers,
                        cfg.qformer().cross_attention_freq))
    want = [cfg.num_hidden_layers * batches, n_cross * batches,
            cfg.num_hidden_layers * batches]
    with open(out, "rb") as fh:
        tokens = pickle.load(fh)
    with open(prog) as fh:
        progress = json.load(fh)
    cache = FieldEmbeddingCache.load(os.path.join(tmp, "front_cache"))
    valid = cache.masks.mean(0)
    log(f"[{smi}] front end, tokens --data (ItemEncoder() + build_cache, "
        f"then the bf16 sweep) at batch {SWEEP_BATCH}: rc {rc}, {len(tokens)} "
        f"items in {cli_s:.2f} s ({n_items / cli_s:.1f} items/s, encoding "
        f"included); B1/B2/B3 launches {launches} (want {want}); fallback "
        f"items {progress['fallback_items']}; valid share per field "
        + ", ".join(f"{f} {v:.2f}" for f, v in zip(cache.fields, valid)))
    if rc != 0 or len(tokens) != n_items or launches != want:
        raise AssertionError(f"tokens --data: rc {rc}, {len(tokens)} items, "
                             f"launches {launches}")
    shape = (cfg.num_query_tokens, cfg.hidden_size)
    if progress["fallback_items"] or not all(
            t.shape == shape and np.isfinite(t).all() for t in tokens.values()):
        raise AssertionError("tokens --data: a fallback or a bad token array")
    if list(cache.fields) != fields or not (valid[fields.index("title")] == 1
                                            and valid.min() > 0):
        raise AssertionError("tokens --data: the encoded cache lost fields")


def front_users(smi: str, tmp: str) -> None:
    """``users`` over phase 4's serving files (bf16, batch USERS_BATCH): the
    CLI in this process (K1 launches checked), the field cache on and off the
    device on one model (row cosine), and ``python3 -m unirec_tpu_torch
    users`` as a subprocess."""
    from unirec_tpu_torch.cli import serve_cli, user_embeddings
    from unirec_tpu_torch.configs import Qwen3Config
    from unirec_tpu_torch.ops.flash_causal import flash_causal_attention
    from unirec_tpu_torch.serving.recommender import Recommender

    serve = os.path.join(tmp, "serve")
    with open(os.path.join(serve, "items.json")) as fh:
        item_ids = list(json.load(fh))
    rng = np.random.default_rng(SEED + 16)
    hist = {f"user{u}": [item_ids[j] for j in rng.choice(
        len(item_ids), rng.integers(1, 16), replace=False)]
        for u in range(USERS_N)}
    with open(os.path.join(tmp, "histories.json"), "w") as fh:
        json.dump(hist, fh)
    base = ["--qformer-checkpoint", os.path.join(serve, "iq"),
            "--cache-dir", os.path.join(serve, "cache"),
            "--item-dict", os.path.join(serve, "items.json"),
            "--catalog", os.path.join(serve, "catalog.json"),
            "--histories", os.path.join(tmp, "histories.json"),
            "--batch-size", str(USERS_BATCH)]
    out = os.path.join(tmp, "users.npy")
    flash_causal_attention.launches = 0
    t0 = time.perf_counter()
    rc = user_embeddings.main(base + ["--output", out])
    cli_s = time.perf_counter() - t0
    launches = flash_causal_attention.launches
    emb_cli = np.load(out)
    with open(out + ".ids.json") as fh:
        ids = json.load(fh)

    rec = serve_cli.build_recommender(user_embeddings.parse_args(
        base + ["--output", out]))
    catalog = {i: rec.catalog[j] for j, i in enumerate(rec.catalog_ids)}
    host = Recommender(rec.model, rec.tokenizer, rec.item_dict, rec.cache,
                       catalog, batch_size=USERS_BATCH,
                       device_field_cache=False)
    histories = list(hist.values())
    rates = {}
    for name, r in (("device", rec), ("host", host)):
        r.encode_users(histories[:USERS_BATCH])  # warm-up
        t0 = time.perf_counter()
        rates[name] = (r.encode_users(histories), time.perf_counter() - t0)
    cos_cache = row_cosines(rates["device"][0], rates["host"][0])
    cos_cli = row_cosines(rates["device"][0], emb_cli)
    del rec, host
    gc.collect()
    torch.cuda.empty_cache()

    out2 = os.path.join(tmp, "users_module.npy")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "unirec_tpu_torch", "users"] + base
        + ["--output", out2, "--host-field-cache"], capture_output=True,
        text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    sub_s = time.perf_counter() - t0
    qwen = Qwen3Config()  # serve_cli's model
    want = -(-USERS_N // USERS_BATCH) * qwen.num_hidden_layers
    log(f"[{smi}] front end, users (bf16, batch {USERS_BATCH}) over phase "
        f"4's files ({len(item_ids)} items): the CLI rc {rc}, {len(ids)} users "
        f"in {cli_s:.2f} s with model building; K1 launches {launches} (want "
        f"{want}); encode_users with the field cache on the device "
        f"{USERS_N / rates['device'][1]:.1f} users/s, on the host "
        f"{USERS_N / rates['host'][1]:.1f} users/s; device vs host min row "
        f"cosine {cos_cache.min():.6f}, vs the CLI {cos_cli.min():.6f} (tol "
        f"{USERS_COS}); python3 -m unirec_tpu_torch users --host-field-cache:"
        f" rc {proc.returncode} in {sub_s:.1f} s")
    if rc != 0 or ids != list(hist) or emb_cli.shape != (USERS_N,
                                                         qwen.hidden_size):
        raise AssertionError("users CLI output")
    if launches != want:
        raise AssertionError(f"users K1 launches {launches}, want {want}")
    if not (cos_cache.min() >= USERS_COS and cos_cli.min() >= USERS_COS):
        raise AssertionError("users: cache on / off the device disagree")
    if proc.returncode != 0:
        raise AssertionError(f"python3 -m unirec_tpu_torch users failed: "
                             f"{proc.stderr[-2000:]}")
    cos_sub = row_cosines(np.load(out2), emb_cli)
    if not cos_sub.min() >= USERS_COS:
        raise AssertionError("python3 -m unirec_tpu_torch users disagrees")


def phase_front_end(smi: str, tmp: str) -> dict:
    """The pipeline's front end: ``data`` over seeded raw files, the text
    backend (K1), the CLIP towers, ``tokens --data`` over phase 5's
    checkpoint (B1-B3) and ``users`` over phase 4's files (K1)."""
    t0 = time.perf_counter()
    root = os.path.join(tmp, "front")
    os.makedirs(root)
    triplet = front_data(root)
    k1_text = front_text_backend(smi, triplet)
    gc.collect()
    torch.cuda.empty_cache()
    front_clip_towers(smi, torch.Generator(device="cuda").manual_seed(
        SEED + 16))
    gc.collect()
    torch.cuda.empty_cache()
    front_tokens(smi, tmp, root, len(triplet))
    front_users(smi, tmp)
    log(f"front end phase: {time.perf_counter() - t0:.1f} s")
    return {"k1_text": k1_text}


def write_train_files(tmp: str, cache, hidden: int) -> dict:
    """The joint trainer's inputs over the sweep's field cache: histories of
    10 cached items, 1024-d candidate embeddings of TRAIN_ITEMS items, train
    samples with 1 + TRAIN_NEG candidates, validation samples with
    VAL_CANDIDATES, and titles; all from the seed."""
    rng = np.random.default_rng(SEED + 1)
    ids = list(cache.item_ids)
    pool = ids[:TRAIN_ITEMS]
    words = ["serum", "lip", "balm", "cherry", "matte", "gloss", "travel",
             "size", "vitamin", "mask", "oil", "brush", "set", "mini", "rose"]

    def samples(n, n_cand):
        out = []
        for _ in range(n):
            cand = [str(c) for c in rng.choice(pool, n_cand, replace=False)]
            out.append({"history": [str(h) for h in rng.choice(ids, 10,
                                                                replace=False)],
                        "candidate": cand,
                        "ground_truth": cand[int(rng.integers(n_cand))]})
        return out

    files = {
        "train": samples(3 * TRAIN_BATCH, 1 + TRAIN_NEG),
        "train1": samples(TRAIN_BATCH, 1 + TRAIN_NEG),
        "val": samples(2 * TRAIN_BATCH, VAL_CANDIDATES),
        "emb": {i: np.round(rng.standard_normal(hidden), 4).tolist()
                for i in pool},
        "items": {i: {"title": " ".join(rng.choice(words, rng.integers(3, 12)))}
                  for i in ids},
    }
    paths = {}
    for name, obj in files.items():
        paths[name] = os.path.join(tmp, f"joint_{name}.json")
        with open(paths[name], "w") as fh:
            json.dump(obj, fh)
    paths.update(data=files)
    return paths


def null_gradient(name: str) -> bool:
    """The attention key biases: their exact gradient is 0 (a bias on every
    key shifts each of a query's scores by one constant, which the softmax
    ignores), so what autograd returns for them is rounding noise."""
    return name.endswith("key.bias")


def grad_cosines(a: dict, b: dict) -> dict:
    """Per-leaf float64 cosine of two gradient dicts: 1 where both are
    exactly 0; a leaf of ``null_gradient`` gets 1 when both of its norms are
    below 1e-3 of the largest leaf norm (its noise), else 0."""
    if set(a) != set(b):
        raise AssertionError(f"gradient leaves differ: {set(a) ^ set(b)}")
    top = max(t.double().norm().item() for t in b.values())
    out = {}
    for name in a:
        x, y = a[name].double().flatten(), b[name].double().flatten()
        nx, ny = x.norm().item(), y.norm().item()
        if nx == ny == 0:  # the extra embedding rows: injection overwrites
            out[name] = 1.0
        elif null_gradient(name):
            out[name] = float(max(nx, ny) <= 1e-3 * top)
        else:
            out[name] = (x @ y).item() / max(nx * ny, 1e-300)
    return out


def noise_leaves(ref: dict) -> set:
    """Leaves of a float32 reference gradient below NOISE_LEAF of its
    largest leaf norm, whose bf16 value is mostly rounding noise: besides
    the key biases (exactly 0, ``null_gradient``), in the user stage the
    query and key projections of the upper layers' self-attention and of
    the first cross-attention, whose queries are the same for every user,
    so that their gradient is a sum of nearly cancelling terms."""
    top = max(t.double().norm().item() for t in ref.values())
    return {n for n, t in ref.items()
            if t.double().norm().item() < NOISE_LEAF * top}


def train_launches() -> dict:
    from unirec_tpu_torch.ops import flash_causal as fc
    from unirec_tpu_torch.ops.int8_matmul import int8_linear

    return {"k1": fc.flash_causal_attention, "b7b_dq": fc.flash_causal_bwd_dq,
            "b7b_dkv": fc.flash_causal_bwd_dkv, "b8": int8_linear}


def phase_train(smi: str, tmp: str) -> dict:
    """Joint training at full width: (b) one step's gradients with
    flash-VJP (K1 forward, B7b backward), on the plain attention path and
    under remat, held to each other; ms per step; then (c) the train CLI."""
    import contextlib
    import dataclasses
    import io

    from unirec_tpu_torch.configs import (
        JointModelConfig,
        LoRAConfig,
        OptimizerConfig,
        Qwen3Config,
        TrainConfig,
    )
    from unirec_tpu_torch.data.cache import FieldEmbeddingCache
    from unirec_tpu_torch.data.tokenizer import HashTokenizer
    from unirec_tpu_torch.inference.qformer_inference import QFormerInference
    from unirec_tpu_torch.ops.dropout import DropoutStream
    from unirec_tpu_torch.train.common import TrainState
    from unirec_tpu_torch.train.joint import (
        JointDataset,
        JointTrainer,
        batch_to_device,
        joint_loss,
        make_joint_optimizer,
        make_joint_train_step,
    )
    from unirec_tpu_torch.utils.params import apply_trainable_mask

    qf_cfg, qf_sd, _ = QFormerInference.read_checkpoint(
        os.path.join(tmp, "ckpt"))
    cache = FieldEmbeddingCache.load(os.path.join(tmp, "cache"))
    qwen = Qwen3Config(flash_vjp_attention=True)
    jc = JointModelConfig(max_length=512)
    files = write_train_files(tmp, cache, qwen.hidden_size)
    opt = OptimizerConfig(learning_rate=1e-4, warmup_steps=20,
                          max_grad_norm=1.0)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    trainer = JointTrainer(
        qwen, dataclasses.replace(qf_cfg, dropout=0.0), jc,
        lora=LoRAConfig(dropout=0.0),
        train_config=TrainConfig(batch_size=TRAIN_BATCH, optimizer=opt),
        dtype="bfloat16", remat=False, bf16_base=True, device="cuda")
    state = trainer.init_state(qformer_params=qf_sd)
    model = state.model
    n_train = sum(p.numel() for p in model.parameters() if p.requires_grad)
    n_all = sum(p.numel() for p in model.parameters())
    log(f"joint training model: Qwen3 {qwen.num_hidden_layers} layers x "
        f"{qwen.hidden_size}, vocab {qwen.vocab_size}+"
        f"{model.num_special_tokens}, LoRA r16 on 7 projections; "
        f"ItemQFormerConfig() from the sweep's checkpoint; L "
        f"{jc.max_length}, batch {TRAIN_BATCH}, {TRAIN_NEG} negatives; bf16 "
        f"compute, {n_train} trainable float32 parameters of {n_all}; built "
        f"in {time.perf_counter() - t0:.1f} s")
    tok = HashTokenizer(qwen.vocab_size, jc.num_history_items,
                        jc.num_query_tokens_per_item)
    ds = JointDataset(files["data"]["train"], files["data"]["emb"], tok,
                      files["data"]["items"], cache, jc,
                      max_negatives=TRAIN_NEG, item_emb_dim=qwen.hidden_size)
    batch = batch_to_device(ds.batch(np.arange(TRAIN_BATCH)), "cuda")
    counters = train_launches()

    def grads_of(m):
        trainable = {n: p for n, p in m.named_parameters() if p.requires_grad}
        for p in trainable.values():
            p.grad = None
        m.train()
        for fn in counters.values():
            fn.launches = 0
        loss = joint_loss(m, batch, DropoutStream(SEED, 0))
        loss.backward()
        torch.cuda.synchronize()
        launches = {n: fn.launches for n, fn in counters.items()}
        grads = {n: p.grad.float().clone() for n, p in trainable.items()
                 if p.grad is not None}
        for p in trainable.values():
            p.grad = None
        return loss.item(), grads, launches

    n_layers = qwen.num_hidden_layers
    loss_f, g_f, l_f = grads_of(model)
    plain = model.clone(qwen_config=dataclasses.replace(
        qwen, flash_vjp_attention=False))
    apply_trainable_mask(plain)
    loss_p, g_p, l_p = grads_of(plain)
    del plain
    remat = model.clone(remat=True, remat_policy="dots")
    apply_trainable_mask(remat)
    loss_r, g_r, l_r = grads_of(remat)
    del remat
    cos_p, cos_r = grad_cosines(g_f, g_p), grad_cosines(g_f, g_r)
    worst_p = min(cos_p, key=cos_p.get)
    worst_r = min(cos_r, key=cos_r.get)
    rel = abs(loss_f - loss_p) / abs(loss_p)
    log(f"joint step, batch {TRAIN_BATCH}: loss flash-VJP {loss_f:.6f}, plain "
        f"attention {loss_p:.6f} (rel {rel:.2e}, tol {STEP_LOSS_REL:g}), "
        f"remat dots {loss_r:.6f}; {len(g_f)} trainable leaves with "
        f"gradients, min cosine vs plain {cos_p[worst_p]:.6f} ({worst_p}), "
        f"vs remat {cos_r[worst_r]:.6f} ({worst_r}) (tol {STEP_GRAD_COS}); "
        f"launches flash {l_f}, plain {l_p}, remat {l_r}")
    if not (rel <= STEP_LOSS_REL and cos_p[worst_p] >= STEP_GRAD_COS
            and cos_r[worst_r] >= STEP_GRAD_COS and np.isfinite(loss_f)):
        raise AssertionError("the flash-VJP step disagrees with the plain "
                             "attention step or with remat")
    want_f = {"k1": n_layers, "b7b_dq": n_layers, "b7b_dkv": n_layers, "b8": 0}
    want_p = {"k1": 0, "b7b_dq": 0, "b7b_dkv": 0, "b8": 0}
    want_r = dict(want_f, k1=2 * n_layers)  # the recompute runs K1 again
    if (l_f, l_p, l_r) != (want_f, want_p, want_r):
        raise AssertionError(f"training launches {l_f} / {l_p} / {l_r}, want "
                             f"{want_f} / {want_p} / {want_r}")
    del g_f, g_p, g_r

    # ms per step with the optimizer, flash-VJP and plain attention
    def step_ms(st, step_fn, n=5):
        for i in range(2):
            st, _ = step_fn(st, ds.batch(np.arange(TRAIN_BATCH)))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for i in range(n):
            st, m = step_fn(st, ds.batch(np.arange(TRAIN_BATCH)))
        loss = m["loss"].item()
        torch.cuda.synchronize()
        return ((time.perf_counter() - t0) / n * 1e3,
                torch.cuda.max_memory_allocated() / 1e9, loss)

    flash_step = make_joint_train_step(model, seed=SEED)
    ms_f, peak_f, last_f = step_ms(state, flash_step)
    plain = model.clone(qwen_config=dataclasses.replace(
        qwen, flash_vjp_attention=False))
    apply_trainable_mask(plain)
    pstate = TrainState(plain, make_joint_optimizer(plain, opt))
    ms_p, peak_p, last_p = step_ms(pstate, make_joint_train_step(plain,
                                                                 seed=SEED))
    del pstate, plain
    ms_f2, peak_f2, _ = step_ms(state, flash_step)
    log(f"[{smi}] joint step at batch {TRAIN_BATCH}, L {jc.max_length}, "
        f"no remat, bf16 base (host clock over 5 synced steps, optimizer "
        f"included): flash-VJP {ms_f:.1f} / {ms_f2:.1f} ms per step, peak "
        f"{peak_f:.2f} GB; plain attention {ms_p:.1f} ms, peak {peak_p:.2f} "
        f"GB; losses after the steps {last_f:.4f} / {last_p:.4f}")
    # the step split on the host clock: forward + backward, then the
    # optimizer's apply over the trainable leaves
    split = {"forward_backward": [], "optimizer": []}
    for _ in range(3):
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        joint_loss(model, batch, DropoutStream(SEED, state.step)).backward()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state.optimizer.step({
            n: p.grad if p.grad is not None else torch.zeros_like(p)
            for n, p in model.named_parameters() if p.requires_grad})
        torch.cuda.synchronize()
        split["forward_backward"].append((t1 - t0) * 1e3)
        split["optimizer"].append((time.perf_counter() - t1) * 1e3)
    model.zero_grad(set_to_none=True)
    log(f"[{smi}] joint step split (host clock, synced, 3 repeats): forward + "
        f"backward {np.median(split['forward_backward']):.1f} ms, optimizer "
        f"apply over {len(state.optimizer.params)} trainable leaves "
        f"{np.median(split['optimizer']):.1f} ms")
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = flash_step(state, ds.batch(np.arange(TRAIN_BATCH)))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = device_time_by_kernel(prof)
    total = sum(t for _, t in rows)
    log(f"[{smi}] one flash-VJP step under torch.profiler: {total:.2f} ms of "
        f"device time in {len(rows)} kernels over {wall:.1f} ms of wall time "
        f"(device idle {100 * (1 - total / wall):.1f}%)"
        + ("" if rows else " (no device rows: breakdown not measured)"))
    for name, t in rows[:14]:
        log(f"  {t:9.3f} ms {100 * t / total:5.1f}%  {name[:110]}")
    del state, model, trainer, flash_step
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the train CLI over the written files
    from unirec_tpu_torch.cli import train_cli

    ck = os.path.join(tmp, "joint_ckpt")
    base = ["joint", "--train-data", files["train"], "--val-data", files["val"],
            "--item-emb", files["emb"], "--item-dict", files["items"],
            "--qformer-checkpoint", os.path.join(tmp, "ckpt"),
            "--cache-dir", os.path.join(tmp, "cache"), "--flash-vjp",
            "--no-remat", "--batch-size", str(TRAIN_BATCH), "--num-epochs", "1",
            "--checkpoint-dir", ck]

    def cli(argv, what):
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = train_cli.main(argv)
        seconds = time.perf_counter() - t0
        out = buf.getvalue()
        for line in out.strip().splitlines():
            log(f"  train_cli {what}| {line[:400]}")
        launches = {n: fn.launches for n, fn in counters.items()}
        log(f"[{smi}] train_cli {what}: rc {rc} in {seconds:.1f} s (model "
            f"build, tokenization and evaluations included), peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, launches "
            f"{launches}")
        if rc != 0:
            raise AssertionError(f"train_cli {what} returned {rc}")
        gc.collect()
        torch.cuda.empty_cache()
        return out, launches

    from unirec_tpu_torch.utils.checkpoint import read_meta

    out, launches = cli(base + ["--eval-every-steps", "2"], "joint, 3 steps")
    evals = out.count('"mrr"')
    meta = read_meta(os.path.join(ck, "latest_model"))
    if evals < 3 or meta.get("step") != 2 or launches["b7b_dq"] != 3 * n_layers:
        raise AssertionError(f"train_cli: {evals} evaluations, checkpoint "
                             f"step {meta.get('step')}, launches {launches}")
    out, launches = cli(base + ["--eval-every-steps", "2", "--resume"],
                        "joint --resume, 3 more steps")
    meta = read_meta(os.path.join(ck, "latest_model"))
    if "resumed from" not in out or meta.get("step") != 5:
        raise AssertionError(f"train_cli --resume: checkpoint step "
                             f"{meta.get('step')}")
    int8_argv = [a if a != files["train"] else files["train1"] for a in base]
    out, launches = cli(int8_argv + ["--int8-base", "--eval-every-steps", "1",
                                     "--checkpoint-dir",
                                     os.path.join(tmp, "joint_int8")],
                        "joint --int8-base, 1 step")
    losses = [float(line.split("loss=")[1].split()[0])
              for line in out.splitlines() if "loss=" in line]
    if launches["b8"] != 7 * n_layers or not losses or not np.isfinite(
            losses[0]):
        raise AssertionError(f"train_cli --int8-base: launches {launches}, "
                             f"losses {losses}")
    log(f"train_cli --int8-base: B8 launched {launches['b8']} times for one "
        f"training forward (7 x {n_layers}), loss {losses[0]:.4f}")
    return {"launches": l_f, "ms_per_step": ms_f}


# -- phase 7: Item Q-Former training ---------------------------------------------


def item_trainer(cfg, sd, fused_anchor: bool, precision: str = "bf16",
                 return_grads: bool = False, device: str = "cuda"):
    """A bf16 item trainer's state (float32 masters) at dropout 0 from the
    weights ``sd`` of ``cfg``, at batch ``ITEM_BATCH`` and lr 1e-4, its
    positive and negative forwards through the fused engine, and its step
    function."""
    import dataclasses

    from unirec_tpu_torch.configs import OptimizerConfig, TrainConfig
    from unirec_tpu_torch.train.item_qformer import (
        ItemQFormerTrainer,
        make_train_step,
    )

    mc = dataclasses.replace(cfg, dropout=0.0, fused_training=fused_anchor)
    tr = ItemQFormerTrainer(
        mc, TrainConfig(batch_size=ITEM_BATCH, seed=SEED,
                        optimizer=OptimizerConfig(learning_rate=1e-4)),
        dtype="bfloat16", fused_reference_forwards=True,
        fused_precision=precision, device=device)
    if not tr.use_fused:
        raise AssertionError("the trainer did not take the fused engine "
                             "for the positive and negative forwards")
    st = tr.init_state(params=sd)
    return st, make_train_step(st.model, fused_reference_config=mc,
                               fused_precision=precision,
                               return_grads=return_grads, seed=SEED)


def item_batches(cache, rng, n: int) -> list:
    """``n`` item-trainer batches of ``ITEM_BATCH`` random pairs of the
    cache's items and their negatives, drawn from ``rng``."""
    from unirec_tpu_torch.train.item_qformer import (
        ItemQFormerTrainer,
        sample_negatives,
    )

    out = []
    for _ in range(n):
        pairs = rng.integers(0, len(cache), (ITEM_BATCH, 2)).astype(np.int32)
        out.append(ItemQFormerTrainer.gather_batch(
            cache, pairs, sample_negatives(rng, pairs, len(cache))))
    return out


HINGE_KEYS = ("hinge_arguments", "item_representation",
              "positive_representation", "negative_representation")


def item_step(cfg, sd, batch, fused_anchor: bool, counters: dict,
              active=None, device: str = "cuda"):
    """One item-trainer step from ``sd`` on ``batch``: (loss, every leaf's
    gradient, the kernels' launches in it, the step's ``HINGE_KEYS``: the
    contrastive hinge's argument per sample and the representations it is
    taken from); ``active`` is the step's ``hinge_active``."""
    st, step = item_trainer(cfg, sd, fused_anchor, return_grads=True,
                            device=device)
    for fn in counters.values():
        fn.launches = 0
    st, m = step(st, batch, active)
    if device == "cuda":
        torch.cuda.synchronize()
    out = (m["loss"].item(), m["grads"],
           {n: fn.launches for n, fn in counters.items()},
           {k: m[k] for k in HINGE_KEYS})
    del st, step, m
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def hinge_rounding(a, p, n, margin: float) -> torch.Tensor:
    """A bound on the rounding of each sample's hinge argument as
    ``ops/losses.triplet_hinge_arguments`` computes it from the anchor,
    positive and negative representations a, p, n, in their promoted dtype
    (unit roundoff u) and in any order of summation: each distance sqrt(sum
    of D squared differences + eps) lies within (D + 4) u of itself (a
    difference, a square, D - 1 additions, eps, the root), and the
    subtraction and the margin add u of their results."""
    dtype = torch.promote_types(torch.promote_types(a.dtype, p.dtype), n.dtype)
    u = torch.finfo(dtype).eps / 2
    a, p, n = (t.detach().double().cpu() for t in (a, p, n))
    d_p, d_n = ((((a - t) ** 2).sum(-1) + 1e-6).sqrt() for t in (p, n))
    return (a.shape[-1] + 6) * u * (d_p + d_n + margin)


def hinge_gate(ref: dict, got: dict, margin: float = 0.5) -> dict:
    """C-12's forward gate on two item steps' ``HINGE_KEYS``: ``ref`` the
    plain anchor's, ``got`` the fused anchor's on ``ref``'s active set.  The
    anchor representation within ``ANCHOR_REP_REL`` of max|ref| with every
    row's cosine >= ``ANCHOR_REP_COS``, and each sample's hinge argument
    within ``bound`` of the reference's: 2 |a_f - a_p| + |p_f - p_p| + |n_f
    - n_p| (row norms) plus both steps' ``hinge_rounding``.  A sample whose
    two arguments lie on the two sides of 0 (a flip) is admitted exactly
    where its argument holds.  Returns ``ok`` and what it read."""
    from unirec_tpu_torch.ops.losses import triplet_hinge_active

    def rows(m, key):
        return m[key].detach().double().cpu()

    a_p = rows(ref, "item_representation")
    a_f = rows(got, "item_representation")
    arg_p, arg_f = rows(ref, "hinge_arguments"), rows(got, "hinge_arguments")
    rel = ((a_f - a_p).abs().max() / a_p.abs().max()).item()
    cos = torch.nn.functional.cosine_similarity(a_f, a_p, dim=-1).min().item()
    lipschitz = 2 * (a_f - a_p).norm(dim=-1) + sum(
        (rows(got, k) - rows(ref, k)).norm(dim=-1)
        for k in ("positive_representation", "negative_representation"))
    bound = lipschitz + sum(
        hinge_rounding(m["item_representation"], m["positive_representation"],
                       m["negative_representation"], margin)
        for m in (ref, got))
    gap = (arg_f - arg_p).abs()
    finite = bool(torch.isfinite(a_f).all() and torch.isfinite(arg_f).all())
    return {"ok": (finite and rel <= ANCHOR_REP_REL and cos >= ANCHOR_REP_COS
                   and bool((gap <= bound).all())),
            "rep_rel": rel, "rep_cos": cos, "gap": gap, "bound": bound,
            "flips": (triplet_hinge_active(arg_f)
                      != triplet_hinge_active(arg_p)).nonzero().flatten(),
            "arg_f": arg_f, "arg_p": arg_p}


def item_step_parity(cfg, sd, batch, counters: dict,
                     device: str = "cuda") -> dict:
    """Phase 7 (a)'s comparison on ``batch``: the plain-anchor step, the
    reference, then the fused-anchor step on the reference's active set of
    the hinge; ``hinge_gate`` on their forwards and the gradient gate (loss
    within ``STEP_LOSS_REL``, every trainable leaf's cosine >=
    ``STEP_GRAD_COS``).  No step runs on a set the code under test chose."""
    from unirec_tpu_torch.ops.losses import triplet_hinge_active

    loss_p, g_p, l_p, m_p = item_step(cfg, sd, batch, False, counters,
                                      device=device)
    active = triplet_hinge_active(m_p["hinge_arguments"])
    loss_f, g_f, l_f, m_f = item_step(cfg, sd, batch, True, counters, active,
                                      device=device)
    gate = hinge_gate(m_p, m_f)
    cos = grad_cosines(g_f, g_p)
    worst = min(cos, key=cos.get)
    rel = abs(loss_f - loss_p) / abs(loss_p)
    ok = (gate["ok"] and rel <= STEP_LOSS_REL and cos[worst] >= STEP_GRAD_COS
          and bool(np.isfinite(loss_f)))
    return {"ok": ok, "gate": gate, "loss_f": loss_f, "loss_p": loss_p,
            "loss_rel": rel, "worst": worst, "cos": cos[worst],
            "leaves": len(cos), "launches_f": l_f, "launches_p": l_p}


def hinge_log(res: dict) -> str:
    """``item_step_parity``'s forward gate in one line."""
    gate = res["gate"]
    flips = [(round(gate["arg_f"][i].item(), 6),
              round(gate["arg_p"][i].item(), 6),
              round(gate["bound"][i].item(), 6))
             for i in gate["flips"].tolist()]
    return (f"anchor representation max|d| {gate['rep_rel']:.2e} of max|ref| "
            f"(tol {ANCHOR_REP_REL:g}), min row cosine {gate['rep_cos']:.7f} "
            f"(tol {ANCHOR_REP_COS}); hinge arguments fused - plain max "
            f"{gate['gap'].max().item():.3e}, least slack to the bound "
            f"{(gate['bound'] - gate['gap']).min().item():.3e} (bounds "
            f"{gate['bound'].min().item():.3e}-"
            f"{gate['bound'].max().item():.3e}); {len(flips)} flips (fused, "
            f"plain, bound): {flips}")


def item_counters() -> dict:
    from unirec_tpu_torch.ops import fused_qformer_int8 as pq
    from unirec_tpu_torch.ops import fused_qformer_layer as fq
    from unirec_tpu_torch.ops import fused_qformer_vjp as fv

    return {"b12s_fwd": fv.self_attention_fwd,
            "b12s_bwd": fv.self_attention_bwd,
            "b12c_fwd": fv.cross_attention_fwd,
            "b12c_bwd": fv.cross_attention_bwd,
            "b1": fq.fused_self_attention_block,
            "b2": fq.fused_cross_attention_block, "b3": fq.fused_ffn_block,
            "b4": pq.fused_self_attention_block_q,
            "b5": pq.fused_cross_attention_block_q,
            "b6": pq.fused_ffn_block_q}


def item_launches(n_layers: int, n_cross: int, steps: int, fused: bool,
                  precision: str = "bf16", eval_batches: int = 0) -> dict:
    """Launches of ``steps`` item-training steps: the anchor's blocks through
    B12s / B12c forward and backward (``fused``), the positive and negative
    forwards through B1-B3 or B4-B6; the fused model's evaluation batches
    run the B12 forwards alone."""
    want = dict.fromkeys(item_counters(), 0)
    if fused:
        want.update(b12s_fwd=n_layers * (steps + eval_batches),
                    b12s_bwd=n_layers * steps,
                    b12c_fwd=n_cross * (steps + eval_batches),
                    b12c_bwd=n_cross * steps)
    refs = ("b1", "b2", "b3") if precision == "bf16" else ("b4", "b5", "b6")
    want.update(zip(refs, (2 * n_layers * steps, 2 * n_cross * steps,
                           2 * n_layers * steps)))
    return want


def write_item_files(tmp: str, cache) -> dict:
    """The item CLI's inputs: an item dict over the sweep's cache items whose
    keys are the cache's fields (so that the CLI loads the cache and encodes
    nothing), and ITEM_CLI_USERS histories of 9 cached items; and an item
    dict of PRECOMPUTE_ITEMS items in the default field schema (text,
    category, image and number fields, some blank) for ``precompute``."""
    rng = np.random.default_rng(SEED + 3)
    ids = list(cache.item_ids)
    items = {i: {f: "x" for f in cache.fields} for i in ids}
    seqs = [{"history": [str(h) for h in rng.choice(ids, 9, replace=False)]}
            for _ in range(ITEM_CLI_USERS)]
    words = ["serum", "lip", "balm", "cherry", "matte", "gloss", "travel",
             "vitamin", "mask", "oil", "brush", "mini", "rose"]

    def text(n):
        return " ".join(rng.choice(words, n))

    raw = {}
    for j in range(PRECOMPUTE_ITEMS):
        raw[f"p{j}"] = {
            "title": text(5), "description": text(12) if j % 10 else "",
            "features": text(8), "main_category": "All Beauty",
            "store": f"store{j % 37}", "brand": f"brand{j % 91}",
            "style": text(1), "color": text(1) if j % 4 else "",
            "size": f"{j % 9} oz", "material": text(1),
            "main_image": f"https://img.example/{j}.jpg",
            "price": round(float(rng.uniform(1, 200)), 2),
            "average_rating": round(float(rng.uniform(1, 5)), 1),
            "rating_number": int(rng.integers(0, 5000))}
    paths = {}
    for name, obj in (("items", items), ("seqs", seqs), ("raw", raw)):
        paths[name] = os.path.join(tmp, f"item_{name}.json")
        with open(paths[name], "w") as fh:
            json.dump(obj, fh)
    paths["raw_items"] = raw
    return paths


def item_train_c10(cli, base, tmp, cache, n_layers, n_cross, steps,
                   val_batches) -> None:
    """C-10: ``train_cli item-qformer --bf16 --hidden-size 1020 --num-heads
    4`` (hidden 1020 is no multiple of 8: B1-B3 and B12 on gemm_wide.cuh's
    edge kernel, hd 255), one epoch with its exact launches, then its
    checkpoint swept by the bf16 (B1-B3) and the int8 (B4-B6) engines:
    finite tokens of the right shape, each engine through its blocks,
    within SWEEP_FP32_COS of the fp32 model."""
    from unirec_tpu_torch.inference.qformer_inference import QFormerInference
    from unirec_tpu_torch.models.item_qformer import ItemQFormer

    ck = os.path.join(tmp, "item_1020")
    what = "item-qformer --bf16 --hidden-size 1020 --num-heads 4, 1 epoch"
    _, launches = cli(base + ["--num-epochs", "1", "--checkpoint-dir", ck,
                              "--hidden-size", "1020", "--num-heads", "4"],
                      what)
    want = item_launches(n_layers, n_cross, steps, True, "bf16", val_batches)
    if launches != want:
        raise AssertionError(f"train_cli {what}: launches {launches}, want "
                             f"{want}")
    cfg, sd, _ = QFormerInference.read_checkpoint(ck)
    rows = np.arange(0, len(cache), len(cache) // SWEEP_SAMPLE)[:SWEEP_SAMPLE]
    emb = torch.from_numpy(np.asarray(cache.embeddings[rows])).to("cuda")
    mask = torch.from_numpy(np.asarray(cache.masks[rows])).to("cuda")
    model32 = ItemQFormer(cfg, device="cuda")
    model32.load_state_dict(sd)
    with torch.inference_mode():
        ref32 = model32.eval().query_outputs(emb, mask)
    counters = item_counters()
    for precision, blocks in (("bf16", ("b1", "b2", "b3")),
                              ("int8", ("b4", "b5", "b6"))):
        before = {n: counters[n].launches for n in blocks}
        engine = QFormerInference(ck, device="cuda", batch_size=ITEM_BATCH,
                                  use_fused=True, precision=precision)
        with torch.inference_mode():
            tokens = engine.forward(emb, mask)
        torch.cuda.synchronize()
        ran = {n: counters[n].launches - before[n] for n in blocks}
        cos = token_cosines(tokens, ref32).min().item()
        log(f"the hidden-1020 checkpoint through the {precision} engine: "
            f"tokens {tuple(tokens.shape)}, launches {ran}, min token cosine "
            f"vs the fp32 ItemQFormer {cos:.6f} (tol {SWEEP_FP32_COS})")
        if not (tokens.shape == (len(rows), cfg.num_query_tokens, 1020)
                and bool(torch.isfinite(tokens.float()).all())
                and all(ran.values()) and cos >= SWEEP_FP32_COS):
            raise AssertionError(f"the hidden-1020 checkpoint fails the "
                                 f"{precision} sweep's checks")
        del engine, tokens
    del model32, ref32, emb, mask
    torch.cuda.empty_cache()


def phase_item_train(smi: str, tmp: str) -> dict:
    """Item Q-Former training at full width over the sweep's checkpoint and
    cache: (a) one step with the fused anchor (B12s / B12c) against the
    plain anchor, (b) a 10-step trajectory of each from one init, (c) ms per
    step and peak memory of three configurations with a split and a
    profile, (d) ``train_cli item-qformer`` / ``--resume`` / ``--int8-ref``,
    ``evaluate`` and ``QFormerInference`` on its checkpoint, (e)
    ``precompute``."""
    import contextlib
    import io

    from unirec_tpu_torch.data.cache import FieldEmbeddingCache, analyze_fields
    from unirec_tpu_torch.inference.qformer_inference import QFormerInference
    from unirec_tpu_torch.models.item_qformer import ItemQFormer
    from unirec_tpu_torch.utils.checkpoint import read_meta

    cfg, sd, _ = QFormerInference.read_checkpoint(os.path.join(tmp, "ckpt"))
    cache_dir = os.path.join(tmp, "cache")
    cache = FieldEmbeddingCache.load(cache_dir)
    counters = item_counters()
    n_layers = cfg.num_hidden_layers
    n_cross = len(range(0, n_layers, cfg.qformer().cross_attention_freq))
    batches = item_batches(cache, np.random.default_rng(SEED + 2), ITEM_STEPS)

    def launches_now():
        return {n: fn.launches for n, fn in counters.items()}

    def zero_counts():
        for fn in counters.values():
            fn.launches = 0

    def trainer(fused_anchor: bool, precision: str = "bf16"):
        return item_trainer(cfg, sd, fused_anchor, precision)

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    # (a) one step, fused anchor against plain anchor (C-12): the plain
    # step first, the reference; the fused step on its active set of the
    # contrastive hinge; the fused forward held to the plain one sample by
    # sample (hinge_gate), then loss and every leaf's gradient
    res = item_step_parity(cfg, sd, batches[0], counters)
    l_f, l_p = res["launches_f"], res["launches_p"]
    want_f = item_launches(n_layers, n_cross, 1, fused=True)
    want_p = item_launches(n_layers, n_cross, 1, fused=False)
    log(f"item step, batch {ITEM_BATCH}, ItemQFormerConfig() at dropout 0, "
        f"the fused anchor on the plain anchor's active set of the hinge: "
        f"{hinge_log(res)}; loss fused anchor {res['loss_f']:.6f}, plain "
        f"anchor {res['loss_p']:.6f} (rel {res['loss_rel']:.2e}, tol "
        f"{STEP_LOSS_REL:g}); {res['leaves']} trainable leaves, min gradient "
        f"cosine {res['cos']:.6f} ({res['worst']}; tol {STEP_GRAD_COS}); "
        f"launches fused {l_f}, plain {l_p}")
    if not res["ok"]:
        raise AssertionError("the fused-anchor step disagrees with the plain "
                             "anchor step")
    if (l_f, l_p) != (want_f, want_p):
        raise AssertionError(f"item step launches {l_f} / {l_p}, want "
                             f"{want_f} / {want_p}")
    del res

    # (b) a trajectory from one init, fused against plain, fitting one batch
    # (random fields: only a batch seen again can be fitted in 10 steps)
    def trajectory(fused_anchor: bool):
        st, step = trainer(fused_anchor)
        losses = []
        for _ in range(ITEM_STEPS):
            st, m = step(st, batches[0])
            losses.append(m["loss"].item())
        del st, step
        release()
        return losses

    traj_f, traj_p = trajectory(True), trajectory(False)
    rels = [abs(a - b) / abs(b) for a, b in zip(traj_f, traj_p)]
    log(f"item trajectory, {ITEM_STEPS} steps on one batch (lr 1e-4, no "
        f"warmup): fused "
        f"anchor {[round(x, 5) for x in traj_f]}, plain anchor "
        f"{[round(x, 5) for x in traj_p]}; max rel {max(rels):.2e} (tol "
        f"{STEP_LOSS_REL:g})")
    if not (max(rels) <= STEP_LOSS_REL and traj_f[-1] < traj_f[0]
            and traj_p[-1] < traj_p[0]):
        raise AssertionError("the trajectories disagree or the loss does not "
                             "fall")

    # (c) ms per step and peak memory; the split and a profile (fused, bf16)
    def step_ms(fused_anchor: bool, precision: str, extra=None):
        st, step = trainer(fused_anchor, precision)
        for b in batches[:2]:
            st, _ = step(st, b)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for b in batches[2:7]:
            st, m = step(st, b)
        m["loss"].item()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 5 * 1e3
        peak = torch.cuda.max_memory_allocated() / 1e9
        if extra is not None:
            extra(st, step)
        del st, step
        release()
        return ms, peak

    def split_and_profile(st, step):
        real = st.optimizer.step
        marks = []

        def apply(grads):  # the optimizer's part, synchronised on both ends
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
        log(f"[{smi}] item step split (host clock, synced, {len(fb)} steps): "
            f"forward + backward + reference forwards "
            f"{np.median(fb):.1f} ms, optimizer apply over "
            f"{len(st.optimizer.params)} leaves {np.median(op):.1f} ms")
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(st, batches[0])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        rows = device_time_by_kernel(prof)
        total = sum(t for _, t in rows)
        log(f"[{smi}] one fused-anchor item step under torch.profiler: "
            f"{total:.2f} ms of device time in {len(rows)} kernels over "
            f"{wall:.1f} ms of wall time (device idle "
            f"{100 * max(0.0, 1 - total / wall):.1f}%)"
            + ("" if rows else " (no device rows: breakdown not measured)"))
        for name, t in rows[:16]:
            log(f"  {t:9.3f} ms {100 * t / total:5.1f}%  {name[:110]}")

    times = {}
    for label, fused_anchor, precision, extra in (
            ("plain anchor, bf16 refs", False, "bf16", None),
            ("fused anchor, bf16 refs", True, "bf16", split_and_profile),
            ("fused anchor, int8 refs", True, "int8", None),
            ("fused anchor, bf16 refs (again)", True, "bf16", None)):
        times[label] = step_ms(fused_anchor, precision, extra)
    log(f"[{smi}] item step at batch {ITEM_BATCH}, ItemQFormerConfig(), bf16 "
        f"compute with float32 masters (host clock over 5 synced steps, "
        f"optimizer included): " + "; ".join(
            f"{k} {ms:.1f} ms, peak {peak:.2f} GB"
            for k, (ms, peak) in times.items()))
    del batches
    release()

    # (d) the train CLI, evaluate, and the sweep's inference on the result
    from unirec_tpu_torch.cli import train_cli

    files = write_item_files(tmp, cache)
    ck, ck8 = os.path.join(tmp, "item_ckpt"), os.path.join(tmp, "item_int8")
    base = ["item-qformer", "--data", files["items"], "--sequences",
            files["seqs"], "--cache-dir", cache_dir, "--bf16", "--fused-anchor",
            "--batch-size", str(ITEM_BATCH), "--eval-every", "1"]

    def cli(argv, what):
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = train_cli.main(argv)
        seconds = time.perf_counter() - t0
        launches = launches_now()
        out = buf.getvalue()
        for line in out.strip().splitlines():
            log(f"  train_cli {what}| {line[:300]}")
        log(f"[{smi}] train_cli {what}: rc {rc} in {seconds:.1f} s (cache "
            f"load, model build and evaluations included), peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, launches "
            f"{launches}")
        if rc != 0:
            raise AssertionError(f"train_cli {what} returned {rc}")
        release()
        return out, launches

    steps = ITEM_CLI_USERS * 8 // ITEM_BATCH  # per epoch (the last cut)
    n_val = len(cache) - int(0.9 * len(cache))
    val_batches = -(-n_val // ITEM_BATCH)
    main_launches = None
    for argv, what, epochs, precision in (
            (["--num-epochs", "2", "--checkpoint-dir", ck],
             "item-qformer --bf16 --fused-anchor, 2 epochs", 2, "bf16"),
            (["--num-epochs", "1", "--checkpoint-dir", ck, "--resume"],
             "item-qformer --resume, 1 epoch", 1, "bf16"),
            (["--num-epochs", "1", "--checkpoint-dir", ck8, "--int8-ref"],
             "item-qformer --int8-ref, 1 epoch", 1, "int8")):
        if "--resume" in argv:
            saved_step = read_meta(ck)["step"]
        out, launches = cli(base + argv, what)
        want = item_launches(n_layers, n_cross, steps * epochs, True,
                             precision, val_batches * epochs)
        if launches != want:
            raise AssertionError(f"train_cli {what}: launches {launches}, "
                                 f"want {want}")
        if main_launches is None:
            main_launches = launches
        if "--resume" in argv and f"at step {saved_step}" not in out:
            raise AssertionError("train_cli --resume did not restore the "
                                 "first run's checkpoint")
    item_train_c10(cli, base, tmp, cache, n_layers, n_cross, steps,
                   val_batches)
    meta = read_meta(ck)
    if not np.isfinite(meta.get("val_recon_loss", np.nan)):
        raise AssertionError(f"item checkpoint meta {meta}")
    out, _ = cli(["evaluate", "--checkpoint", ck, "--cache-dir", cache_dir,
                  "--batch-size", str(ITEM_BATCH)], "evaluate")
    res = json.loads(out[out.index("{"):])
    if not (res["num_samples"] == len(cache)
            and np.isfinite(res["val_recon_loss"])
            and 0.0 < res["avg_cosine_similarity"] <= 1.0):
        raise AssertionError(f"train_cli evaluate: {res}")
    inference = QFormerInference(ck, device="cuda", batch_size=ITEM_BATCH,
                                 use_fused=True)
    rows = np.arange(0, len(cache), len(cache) // SWEEP_SAMPLE)[:SWEEP_SAMPLE]
    emb = torch.from_numpy(np.asarray(cache.embeddings[rows])).to("cuda")
    mask = torch.from_numpy(np.asarray(cache.masks[rows])).to("cuda")
    tcfg, tsd, _ = QFormerInference.read_checkpoint(ck)
    model32 = ItemQFormer(tcfg, device="cuda")
    model32.load_state_dict(tsd)
    with torch.inference_mode():
        tokens = inference.forward(emb, mask)
        ref32 = model32.eval().query_outputs(emb, mask)
    cos32 = token_cosines(tokens, ref32)
    log(f"QFormerInference (bf16 engine) on the trained checkpoint (step "
        f"{meta.get('step')}, val_recon_loss {meta['val_recon_loss']:.6f}): "
        f"tokens {tuple(tokens.shape)}, min token cosine vs the fp32 "
        f"ItemQFormer {cos32.min().item():.6f} (tol {SWEEP_FP32_COS})")
    if not (tokens.shape == (len(rows), cfg.num_query_tokens, cfg.hidden_size)
            and bool(torch.isfinite(tokens.float()).all())
            and cos32.min().item() >= SWEEP_FP32_COS):
        raise AssertionError("the trained checkpoint's tokens fail the check")
    del inference, model32, tokens, ref32, emb, mask
    release()

    # (e) precompute: the hash and MWNE backends into a cache, reloaded
    pre_dir = os.path.join(tmp, "precomputed")
    t0 = time.perf_counter()
    rc = train_cli.main(["precompute", "--data", files["raw"], "--cache-dir",
                         pre_dir])
    seconds = time.perf_counter() - t0
    pre = FieldEmbeddingCache.load(pre_dir)
    raw = list(files["raw_items"].values())
    norms = np.linalg.norm(np.asarray(pre.embeddings), axis=-1)
    price = pre.fields.index("price")
    blank = pre.fields.index("description")
    log(f"train_cli precompute: rc {rc}, {len(pre)} items x "
        f"{pre.num_fields} fields x {pre.embedding_dim} in {seconds:.1f} s; "
        f"{int((np.asarray(pre.masks) == 0).sum())} missing fields")
    if not (rc == 0 and len(pre) == PRECOMPUTE_ITEMS
            and pre.fields == analyze_fields(raw)
            and pre.embedding_dim == cfg.field_embedding_dim
            and np.allclose(norms[:, price], 1.0, atol=1e-4)
            and not pre.masks[0, blank] and pre.masks[1, blank]
            and np.array_equal(np.asarray(pre.masks), (norms > 0))):
        raise AssertionError("the precomputed cache fails its checks")
    return {"launches": main_launches, "ms": times}


def user_counters() -> dict:
    from unirec_tpu_torch.ops import attention as pa
    from unirec_tpu_torch.ops import flash_vjp as fl
    from unirec_tpu_torch.ops import fused_qformer_vjp as fv

    return {"b13": pa.flash_cross_attention, "b14_fwd": fl.flash_cross_fwd,
            "b14_bwd": fl.flash_cross_bwd, "b12s_fwd": fv.self_attention_fwd,
            "b12s_bwd": fv.self_attention_bwd,
            "b12c_fwd": fv.cross_attention_fwd,
            "b12c_bwd": fv.cross_attention_bwd}


def user_launches(n_layers: int, steps: int, eval_batches: int,
                  kernels: bool, fused: bool = True) -> dict:
    """Launches of ``steps`` user-training steps and ``eval_batches``
    evaluation forwards: with ``--flash --fused`` every layer's cross block
    through B14 and (``fused``: bf16 compute, the JAX dispatch's rule) self
    block through B12s, forward in both, backward in the steps; otherwise
    the steps take the plain path and every evaluation layer B13 (its
    1,600-row memory).  The 1,600-row cross side never takes B12c."""
    want = dict.fromkeys(user_counters(), 0)
    if kernels:
        want.update(b14_fwd=n_layers * (steps + eval_batches),
                    b14_bwd=n_layers * steps)
    if kernels and fused:
        want.update(b12s_fwd=n_layers * (steps + eval_batches),
                    b12s_bwd=n_layers * steps)
    else:
        want.update(b13=n_layers * eval_batches)
    return want


def write_user_files(tmp: str, cache) -> dict:
    """The user CLI's inputs over the sweep's cache: USER_CLI_USERS
    histories of 20-60 items, about 5% of them missing from the cache (user
    0's first three: its first samples have no valid event), and a review
    dict keyed "user|item" with Unix review times."""
    rng = np.random.default_rng(SEED + 4)
    ids = list(cache.item_ids)
    histories, reviews = [], {}
    for u in range(USER_CLI_USERS):
        hist = [str(h) for h in rng.choice(ids, int(rng.integers(20, 61)),
                                           replace=False)]
        for j in range(len(hist)):
            if (u == 0 and j < 3) or rng.random() < 0.05:
                hist[j] = f"gone{u}_{j}"
        histories.append({"history": hist})
        for h in hist:
            reviews[f"u{u}|{h}"] = {
                "unixReviewTime": int(rng.integers(1_200_000_000,
                                                   1_700_000_000))}
    paths = {}
    for name, obj in (("history", histories), ("reviews", reviews)):
        paths[name] = os.path.join(tmp, f"user_{name}.json")
        with open(paths[name], "w") as fh:
            json.dump(obj, fh)
    paths["histories"] = histories
    by_item: dict = {}  # the CLI's regrouping of the review dict per item
    for key, review in reviews.items():
        by_item.setdefault(key.split("|", 1)[-1], []).append(review)
    paths["reviews_by_item"] = by_item
    return paths


def phase_user_train(smi: str, tmp: str, heads=None,
                     evaluate: bool = True, dtype: str = "bfloat16") -> dict:
    """User Q-Former training at full width (``UserQFormerConfig()`` over the
    sweep's checkpoint and cache, --max-seq-len 50, batch 64, bf16 compute
    with float32 masters): (b) one step with ``--flash --fused`` (B14 in
    every cross layer, B12s in every self layer) against the plain step from
    one init at dropout 0, loss and every leaf's gradient, ms per step, the
    split and peak memory of both; (c) ``train_cli user-qformer --bf16
    --flash --fused`` for 2 epochs, ``--resume`` for 1, then ``--bf16
    --remat`` for 1, whose evaluation goes through B13; exact launches.

    With ``heads`` (the chunked kernels' phase (b): 2 heads of 512; C-19: 1
    head of 1024): the step parity of (b) alone at
    ``num_attention_heads=heads``, then (``evaluate``) one evaluation
    forward of the plain model, whose cross layers take B13, and ms per
    step, device idle share, B14's device time and peak memory of the
    ``--flash --fused`` step; returns those launches and times.  ``dtype``
    "float32" (with ``heads``) runs both steps at float32 compute, the train
    CLI's default precision (the chunked B14 in the 3xTF32 cluster form at
    2 heads of 512), held to each other at the bf16 step's gates."""
    import contextlib
    import dataclasses
    import io

    from unirec_tpu_torch.cli import train_cli
    from unirec_tpu_torch.configs import (
        OptimizerConfig,
        TrainConfig,
        UserQFormerConfig,
    )
    from unirec_tpu_torch.data.cache import FieldEmbeddingCache
    from unirec_tpu_torch.inference.qformer_inference import QFormerInference
    from unirec_tpu_torch.models.item_qformer import ItemQFormer
    from unirec_tpu_torch.train.user_qformer import (
        UserQFormerTrainer,
        build_sliding_window_samples,
        build_timestamp_map,
        make_train_step,
        precompute_item_tokens,
    )
    from unirec_tpu_torch.utils.checkpoint import read_meta

    ckpt = os.path.join(tmp, "ckpt")
    cfg, sd, _ = QFormerInference.read_checkpoint(ckpt)
    cache_dir = os.path.join(tmp, "cache")
    cache = FieldEmbeddingCache.load(cache_dir)
    counters = user_counters()
    files = write_user_files(tmp, cache)
    samples = build_sliding_window_samples(files["histories"],
                                           max_seq_len=USER_SEQ)
    item_qformer = ItemQFormer(cfg, device="cuda")
    item_qformer.load_state_dict(sd)
    t0 = time.perf_counter()
    tokens = precompute_item_tokens(item_qformer, cache)
    log(f"user stage: {len(samples)} sliding-window samples of "
        f"{USER_CLI_USERS} users; the catalog's item tokens "
        f"{tokens.shape} in {time.perf_counter() - t0:.1f} s")
    if not (tokens.shape == (len(cache), cfg.num_query_tokens, cfg.hidden_size)
            and np.isfinite(tokens).all()):
        raise AssertionError("precompute_item_tokens fails its checks")
    del item_qformer
    ts_map = build_timestamp_map(files["reviews_by_item"])
    uc0 = UserQFormerConfig(num_item_tokens_to_predict=cfg.num_query_tokens,
                            input_embedding_dim=cfg.hidden_size, dropout=0.0)
    if heads is not None:
        uc0 = dataclasses.replace(uc0, num_attention_heads=heads)
    n_layers = uc0.num_hidden_layers
    tc = TrainConfig(batch_size=USER_BATCH, seed=SEED,
                     optimizer=OptimizerConfig(learning_rate=5e-5))
    rng = np.random.default_rng(SEED + 5)
    order = rng.permutation(len(samples))
    probe = UserQFormerTrainer(uc0, tc, USER_SEQ, dtype="bfloat16",
                               device="cuda")
    batches = [probe.make_batch(samples, order[i:i + USER_BATCH], tokens,
                                cache, ts_map)
               for i in range(0, 10 * USER_BATCH, USER_BATCH)]
    masked = int((batches[0]["seq_mask"].sum(1) == 0).sum())

    def launches_now():
        return {n: fn.launches for n, fn in counters.items()}

    def zero_counts():
        for fn in counters.values():
            fn.launches = 0

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    def trainer(kernels: bool, return_grads: bool = False,
                dtype: str = dtype):
        """A trainer's state from the seed at dropout 0, with ``--flash
        --fused`` (kernels) or without, and its step."""
        uc = dataclasses.replace(uc0, flash_training=kernels,
                                 fused_training=kernels)
        st = UserQFormerTrainer(uc, tc, USER_SEQ, dtype=dtype,
                                device="cuda").init_state()
        return st, make_train_step(st.model, return_grads=return_grads,
                                   seed=SEED)

    # (b) one step each way from one init (and the plain step in float32 as
    # the reference of both), then ms per step and the split
    def one_step(kernels: bool, dtype: str = dtype):
        st, step = trainer(kernels, return_grads=True, dtype=dtype)
        zero_counts()
        st, m = step(st, batches[0])
        torch.cuda.synchronize()
        launches = launches_now()
        loss = m["loss"].item()
        grads = {n: g.double() for n, g in m["grads"].items()}
        del st, step, m
        release()
        return loss, grads, launches

    from unirec_tpu_torch.ops import attention as pa
    from unirec_tpu_torch.ops import flash_vjp as fl

    form_counts = (pa.launch_flash_cross_fwd.forms,
                   fl.launch_flash_cross_bwd.forms)
    for f in form_counts:
        f.clear()
    loss_k, g_k, l_k = one_step(True)
    head_dim = uc0.hidden_size // uc0.num_attention_heads
    if head_dim > 256:  # B14 in the chunked form: the forms named
        want = chunked_forms(head_dim, getattr(torch, dtype))
        ran = [dict(f) for f in form_counts]
        if ran != [{want["fwd"]: n_layers}, {want["rows"]: n_layers}]:
            raise AssertionError(f"user step at head dim {head_dim}: B14 "
                                 f"ran the forms {ran}")
        log(f"user step at head dim {head_dim}: B14 forward {want['fwd']},"
            f" backward {want['rows']} in each of {n_layers} cross layers")
    loss_p, g_p, l_p = one_step(False)
    # the float32 plain step, the reference of both (at float32 compute,
    # the plain step itself)
    loss_32, g_32, _ = ((loss_p, g_p, None) if dtype == "float32"
                        else one_step(False, "float32"))
    noise = noise_leaves(g_32)
    top = max(t.norm().item() for t in g_32.values())
    cos = {n: c for n, c in grad_cosines(g_k, g_p).items() if n not in noise}
    worst = min(cos, key=cos.get)
    noisy = max(max(g_k[n].norm().item(), g_p[n].norm().item()) / top
                for n in noise)

    def cosine(x, y):
        x, y = x.flatten(), y.flatten()
        return (x @ y).item() / max(x.norm().item() * y.norm().item(), 1e-300)

    vs32 = {n: (cosine(g_k[n], t), cosine(g_p[n], t)) for n, t in g_32.items()}
    # the bf16 steps' noise leaves against the float32 step (at float32
    # compute the plain step is that step: no gap to hold)
    gap, widest = max((((1 - vs32[n][0]) / max(1 - vs32[n][1], 1e-12), n)
                       for n in noise if not null_gradient(n)
                       and dtype != "float32"), default=(0.0, "none"))
    rel = abs(loss_k - loss_p) / abs(loss_p)
    # at float32 compute the self blocks take the plain path (B12s is the
    # bf16 blocks' dispatch, models/qformer._fused_ok)
    want_k = user_launches(n_layers, 1, 0, True, fused=dtype == "bfloat16")
    want_p = user_launches(n_layers, 1, 0, False)
    log(f"user step, batch {USER_BATCH} ({masked} with no valid event), "
        f"UserQFormerConfig({'' if heads is None else f'num_attention_heads={heads}'})"
        f" at --max-seq-len {USER_SEQ}, {dtype} compute, dropout 0: loss "
        f"--flash --fused {loss_k:.6f}, plain {loss_p:.6f}, plain float32 "
        f"{loss_32:.6f} (rel {rel:.2e}, tol {STEP_LOSS_REL:g}); {len(cos)} of "
        f"{len(g_k)} leaves above {NOISE_LEAF:g} of the largest float32 leaf "
        f"norm, min gradient cosine {cos[worst]:.6f} ({worst}; tol "
        f"{STEP_GRAD_COS}); the other {len(noise)} at most {noisy:.2e} of it "
        f"in bf16 (tol {2 * NOISE_LEAF:g}), their distance from the float32 "
        f"step at most {gap:.3f} times the plain step's ({widest}; "
        f"tol {NOISE_GAP_RATIO:g}); launches --flash --fused {l_k}, plain "
        f"{l_p}")
    all_cos = grad_cosines(g_k, g_p)
    for n in sorted(g_32, key=all_cos.get)[:12]:
        log(f"  {'noise ' if n in noise else 'gated '}{n}: |g|/top "
            f"{g_32[n].norm().item() / top:.2e}, cosine --flash --fused to "
            f"plain {all_cos[n]:.6f}; to float32: --flash --fused "
            f"{vs32[n][0]:.6f}, plain bf16 {vs32[n][1]:.6f}")
    worst32 = min((n for n in g_32 if n not in noise), key=lambda n: vs32[n][0])
    log(f"  against the float32 step, worst leaf above it: {worst32}: "
        f"--flash --fused {vs32[worst32][0]:.6f}, plain bf16 "
        f"{vs32[worst32][1]:.6f}")
    if not (rel <= STEP_LOSS_REL and cos[worst] >= STEP_GRAD_COS
            and noisy <= 2 * NOISE_LEAF and gap <= NOISE_GAP_RATIO
            and np.isfinite(loss_k)):
        raise AssertionError("the --flash --fused user step disagrees with "
                             "the plain step")
    if (l_k, l_p) != (want_k, want_p):
        raise AssertionError(f"user step launches {l_k} / {l_p}, want "
                             f"{want_k} / {want_p}")
    del g_k, g_p, g_32

    def step_ms(kernels: bool):
        st, step = trainer(kernels)
        for b in batches[:2]:
            st, _ = step(st, b)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for b in batches[2:7]:
            st, m = step(st, b)
        m["loss"].item()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 5 * 1e3
        peak = torch.cuda.max_memory_allocated() / 1e9
        real = st.optimizer.step
        marks = []

        def apply(grads):  # the optimizer's part, synchronised on both ends
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
        idle = b14 = None
        if kernels:
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(st, batches[0])
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            rows = device_time_by_kernel(prof)
            total = sum(t for _, t in rows)
            idle = max(0.0, 1 - total / wall) if rows else None
            log(f"[{smi}] one --flash --fused user step under torch.profiler:"
                f" {total:.2f} ms of device time in {len(rows)} kernels over "
                f"{wall:.1f} ms of wall time (device idle "
                f"{100 * max(0.0, 1 - total / wall):.1f}%; the step copies "
                f"its [64, 50, 32, 1024] float32 batch to the card)"
                + ("" if rows else " (no device rows: not measured)"))
            for name, t in rows[:12]:
                log(f"  {t:9.3f} ms {100 * t / total:5.1f}%  {name[:110]}")
            # B14: the kernels of flash_cross.cu, or above hd 256 the
            # chunked forms' (flash_chunked.cuh, flash_chunked_cluster.cuh)
            b14 = {kind: sum(t for name, t in rows if any(
                k in name for k in names)) for kind, names in (
                    ("fwd", ("flash_cross_fwd", "chunk_fwd")),
                    ("bwd", ("flash_cross_bwd", "flash_cross_dkv_sum",
                             "chunk_bwd_rows", "chunk_dkv_sum")))}
            log(f"  B14 in that step: forward {b14['fwd']:.3f} ms, backward "
                f"{b14['bwd']:.3f} ms, "
                f"{100 * sum(b14.values()) / max(total, 1e-9):.1f}% of the "
                "device time")
        del st, step
        release()
        return dict(ms=ms, peak_gb=peak, fwd_bwd_ms=float(np.median(fb)),
                    optimizer_ms=float(np.median(op)), idle=idle,
                    b14_device_ms=b14)

    if heads is not None:
        l_eval = {"b13": 0}
        if evaluate:  # the plain model's evaluation forward: B13
            from unirec_tpu_torch.train.user_qformer import (
                batch_to_device,
                user_forward,
            )

            st, _ = trainer(False)
            zero_counts()
            st.model.eval()
            with torch.no_grad():
                pred = user_forward(st.model,
                                    batch_to_device(batches[0], "cuda"))
            torch.cuda.synchronize()
            l_eval = launches_now()
            log(f"user evaluation forward at {heads} heads: launches "
                f"{l_eval}")
            if (l_eval != user_launches(n_layers, 0, 1, False)
                    or not bool(torch.isfinite(pred).all())):
                raise AssertionError(f"user evaluation at {heads} heads: "
                                     f"launches {l_eval}")
            del st, pred
            release()
        t = step_ms(True)
        log(f"[{smi}] user step at batch {USER_BATCH}, UserQFormerConfig("
            f"num_attention_heads={heads}) (head dim "
            f"{uc0.hidden_size // heads}), --flash --fused, {dtype} compute "
            f"with float32 masters (host clock over 5 synced steps, the batch's "
            f"copy to the card and the optimizer included; split over "
            f"{len(batches) - 7} steps): {t['ms']:.1f} ms (forward + backward "
            f"{t['fwd_bwd_ms']:.1f}, optimizer {t['optimizer_ms']:.1f}), "
            f"device idle " + ("not measured" if t["idle"] is None
                               else f"{100 * t['idle']:.1f}%")
            + f", peak {t['peak_gb']:.2f} GB")
        del batches, tokens
        release()
        return {"launches": {**l_k, "b13": l_eval["b13"]}, "ms": t,
                "forms": (want if head_dim > 256 else None)}

    times = {"plain": step_ms(False), "--flash --fused": step_ms(True),
             "plain (again)": step_ms(False)}
    log(f"[{smi}] user step at batch {USER_BATCH}, UserQFormerConfig(), "
        f"bf16 compute with float32 masters (host clock over 5 synced steps, "
        f"the batch's copy to the card and the optimizer included; split over "
        f"{len(batches) - 7} steps): " + "; ".join(
            f"{k} {t['ms']:.1f} ms (forward + backward {t['fwd_bwd_ms']:.1f},"
            f" optimizer {t['optimizer_ms']:.1f}), peak {t['peak_gb']:.2f} GB"
            for k, t in times.items()))
    del batches, tokens
    release()

    # (c) the train CLI: --flash --fused, --resume, then --remat (B13)
    ck, ck_remat = os.path.join(tmp, "user_ckpt"), os.path.join(tmp,
                                                                "user_remat")
    base = ["user-qformer", "--item-qformer-checkpoint", ckpt, "--history",
            files["history"], "--reviews", files["reviews"], "--cache-dir",
            cache_dir, "--bf16", "--batch-size", str(USER_BATCH),
            "--max-seq-len", str(USER_SEQ)]
    n_train = max(int(0.9 * len(samples)), 1)
    steps = n_train // USER_BATCH  # per epoch (the last cut)
    eval_batches = -(-(len(samples) - n_train) // USER_BATCH)
    main_launches = None
    for argv, what, epochs, kernels in (
            (["--flash", "--fused", "--num-epochs", "2", "--checkpoint-dir",
              ck], "user-qformer --bf16 --flash --fused, 2 epochs", 2, True),
            (["--flash", "--fused", "--num-epochs", "1", "--checkpoint-dir",
              ck, "--resume"], "user-qformer --resume, 1 epoch", 1, True),
            (["--remat", "--num-epochs", "1", "--checkpoint-dir", ck_remat],
             "user-qformer --bf16 --remat, 1 epoch", 1, False)):
        if "--resume" in argv:
            saved_step = read_meta(ck)["step"]
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = train_cli.main(base + argv)
        seconds = time.perf_counter() - t0
        launches = launches_now()
        out = buf.getvalue()
        for line in out.strip().splitlines():
            log(f"  train_cli {what}| {line[:300]}")
        log(f"[{smi}] train_cli {what}: rc {rc} in {seconds:.1f} s (item "
            f"tokens, model build, checkpoints and evaluation included), "
            f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB, "
            f"launches {launches}")
        if rc != 0:
            raise AssertionError(f"train_cli {what} returned {rc}")
        want = user_launches(n_layers, steps * epochs, eval_batches, kernels)
        if launches != want:
            raise AssertionError(f"train_cli {what}: launches {launches}, "
                                 f"want {want}")
        if main_launches is None:
            main_launches = dict(launches)
        if not kernels:  # the main path's evaluation without --flash: B13
            main_launches["b13"] = launches["b13"]
        if "--resume" in argv and f"at step {saved_step}" not in out:
            raise AssertionError("train_cli --resume did not restore the "
                                 "first run's checkpoint")
        res = json.loads(out[out.rindex("\n{") + 1:])
        if not (np.isfinite(res["loss"]) and np.isfinite(res["token_mse"])
                and -1.0 <= res["token_cosine"] <= 1.0
                and 0.0 < res["retrieval_mrr"] <= 1.0):
            raise AssertionError(f"train_cli {what}: metrics {res}")
        release()
    return {"launches": main_launches, "ms": times}


# -- phases (b)-(e): the Q-Former's LM head, MWNE training, the exporters ----


def lm_step_logits(model, query, memory, mask, ids, step):
    """Both decoders' float32 logits [B, vocab] at ``step`` (the token
    ``step + 1`` is chosen from them), teacher-forced on ``ids``: the full
    forward's, and the KV-cached decoder's (``models/qformer_decode``'s
    prefill and steps)."""
    from unirec_tpu_torch.models import qformer_decode as qd

    b, n_q = query.shape[:2]
    t = ids.shape[1]
    text = (torch.arange(t, device=ids.device) <= step).float()
    full_mask = torch.cat([torch.ones(b, n_q, device=ids.device),
                           text[None].expand(b, -1)], dim=1)
    with torch.no_grad():
        full = model(ids, full_mask, query, memory, mask)[:, step].float()
        k_cache, v_cache = qd._caches(*qd._prefill(model, query, memory, mask),
                                      t)
        for s in range(step + 1):
            h = qd._decode_step(model, qd._embed_token(model, ids[:, s], s),
                                k_cache, v_cache,
                                qd._visible(n_q + t, n_q + s, ids.device),
                                n_q + s)
        cached = model.cls(h)[:, 0].float()
    return full, cached


def near_ties(model, query, memory, mask, full_ids, cached_ids) -> list:
    """Each row where the two decoders' ids differ: (row, step, the full
    forward's top-2 logit gap, the cached decoder's) at the first
    difference, both decoders fed the common prefix."""
    rows = (full_ids != cached_ids).any(1).nonzero().flatten().tolist()
    out = []
    for r in rows:
        step = int((full_ids[r] != cached_ids[r]).nonzero()[0]) - 1
        sl = slice(r, r + 1)
        full, cached = lm_step_logits(model, query[sl], memory[sl], mask[sl],
                                      full_ids[sl], step)
        gaps = [float(x.topk(2).values[0, 0] - x.topk(2).values[0, 1])
                for x in (full, cached)]
        top2 = [set(x.topk(2).indices[0].tolist()) for x in (full, cached)]
        picked = {int(full_ids[r, step + 1]), int(cached_ids[r, step + 1])}
        out.append((r, step, *gaps, picked <= top2[0] and picked <= top2[1]))
    return out


def phase_lm_decode(smi: str) -> dict:
    """(c) ``QFormerLMHeadModel`` at ``QFormerConfig()`` (12 layers, hidden
    1024, vocab 30,522; seed-0 weights), batch LM_BATCH, 32 query tokens over
    a LM_MEMORY-row memory (ViT-L/14's patch tokens): greedy decoding of
    LM_TOKENS tokens by ``greedy_generate`` (a full forward a step) and by
    ``kv_cached_greedy_generate``, token for token equal in float32 but at
    a rounding near-tie (``near_ties``: a row may part where, fed the
    common prefix, both decoders' top-2 logits lie within LM_TIE of each
    other and each picks one of them; at most LM_TIE_ROWS rows); the same
    weights in bf16 (float32 masters): both decoders' agreement with each
    other and with float32, tokens/s of each."""
    from unirec_tpu_torch.configs import QFormerConfig
    from unirec_tpu_torch.models.qformer import (
        QFormerLMHeadModel,
        greedy_generate,
    )
    from unirec_tpu_torch.models.qformer_decode import kv_cached_greedy_generate
    from unirec_tpu_torch.utils.weights import init_qformer_lm_head

    cfg = QFormerConfig()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    model = init_qformer_lm_head(cfg, gen, device="cuda")
    query = torch.randn(LM_BATCH, cfg.query_length, cfg.hidden_size,
                        device="cuda", generator=gen)
    memory = torch.randn(LM_BATCH, LM_MEMORY, cfg.encoder_width,
                         device="cuda", generator=gen)
    mask = torch.ones(LM_BATCH, LM_MEMORY, device="cuda")
    mask[1, 200:] = 0.0
    out, ms = {}, {}

    def run(name, fn, m):
        fn(m, query[:2], memory[:2], mask[:2], max_new_tokens=4)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = fn(m, query, memory, mask, max_new_tokens=LM_TOKENS)
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
        out[name] = ids
        return ids

    # greedy_generate's default ids: BOS the last row of the vocabulary,
    # EOS 102 ([SEP])
    ends = dict(bos_token_id=cfg.vocab_size - 1, eos_token_id=102)

    def kv(m, *args, **kw):
        return kv_cached_greedy_generate(m, *args, **ends, **kw)

    def full(m, *args, **kw):
        return greedy_generate(m, *args, **ends, **kw)

    run("full fp32", full, model)
    run("cached fp32", kv, model)
    ties = near_ties(model, query, memory, mask, out["full fp32"],
                     out["cached fp32"])
    for r, step, gap_full, gap_cached, in_top2 in ties:
        log(f"  (c) fp32 row {r} parts at step {step}: top-2 logit gap full "
            f"{gap_full:.3e}, cached {gap_cached:.3e}, picks within both "
            f"top-2 {in_top2}")
    bf16 = QFormerLMHeadModel(cfg, device="cuda", dtype=torch.bfloat16,
                              param_dtype=torch.float32).eval()
    bf16.load_state_dict(model.state_dict())
    del model
    torch.cuda.empty_cache()
    run("full bf16", full, bf16)
    run("cached bf16", kv, bf16)
    new = LM_BATCH * (LM_TOKENS - 1)

    def agree(a, b):
        return float((out[a] == out[b]).float().mean())

    same32 = torch.equal(out["full fp32"], out["cached fp32"])
    rates = {k: new / (v / 1e3) for k, v in ms.items()}
    log(f"[{smi}] (c) QFormerLMHeadModel at QFormerConfig(), batch "
        f"{LM_BATCH}, {cfg.query_length} query tokens over {LM_MEMORY} memory "
        f"rows, {LM_TOKENS} tokens ({new} generated): fp32 KV-cached ids equal"
        f" to greedy_generate's: {same32} ({len(ties)} rows part at a "
        f"near-tie; fp32 agreement {agree('cached fp32', 'full fp32'):.4f}); "
        f"bf16 agreement cached/full "
        f"{agree('cached bf16', 'full bf16'):.4f}, bf16 cached/fp32 "
        f"{agree('cached bf16', 'full fp32'):.4f}; " + ", ".join(
            f"{k} {ms[k]:.1f} ms ({rates[k]:.1f} tokens/s)" for k in ms))
    if not (len(ties) <= LM_TIE_ROWS and all(
            max(g_f, g_c) <= LM_TIE and in_top2
            for _, _, g_f, g_c, in_top2 in ties)):
        raise AssertionError(f"(c) KV-cached greedy ids differ from "
                             f"greedy_generate's in fp32 beyond near-ties: "
                             f"{ties}")
    if not all(bool((ids >= 0).all() and (ids < cfg.vocab_size).all())
               for ids in out.values()):
        raise AssertionError("(c) ids outside the vocabulary")
    del bf16
    torch.cuda.empty_cache()
    return {"ms": ms, "tokens_per_s": rates,
            "bf16_agreement": agree("cached bf16", "full bf16")}


def phase_mwne(smi: str, tmp: str) -> str:
    """(d) ``python3 -m unirec_tpu_torch train mwne`` at ``MWNEConfig()``
    (1,500 steps, batch 64, on the card) as a subprocess: exit 0, finite
    metrics, the total loss below its first step's; returns the checkpoint
    directory."""
    ck = os.path.join(tmp, "mwne")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "unirec_tpu_torch", "train",
                           "mwne", "--checkpoint-dir", ck],
                          capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"(d) train mwne returned {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    res = json.loads(proc.stdout[proc.stdout.index("{"):])
    train = res["train"]
    log(f"[{smi}] (d) python3 -m unirec_tpu_torch train mwne (MWNEConfig(), "
        f"1,500 steps): rc 0 in {seconds:.1f} s (start-up included); total "
        f"loss {train['total_first']:.5f} -> {train['total']:.5f}; eval "
        f"{json.dumps(res['eval'])}")
    if not (all(np.isfinite(v) for v in train.values())
            and train["total"] < train["total_first"]):
        raise AssertionError(f"(d) train mwne: the loss did not fall: {train}")
    return ck


def same_tensors(what: str, got: dict, want: dict) -> None:
    """Re-read tensors equal to the checkpoint's, key for key, in float32."""
    if set(got) != set(want):
        raise AssertionError(f"(e) {what}: keys differ: "
                             f"{sorted(set(got) ^ set(want))[:6]}")
    bad = [k for k in want if not torch.equal(got[k].float().cpu(),
                                              want[k].float().cpu())]
    if bad:
        raise AssertionError(f"(e) {what}: tensors differ at {bad[:6]}")


def phase_exports(smi: str, tmp: str, mwne_dir: str) -> None:
    """(e) ``train export-pth`` of the item (phase 7), user (phase 8) and
    MWNE ((d)) checkpoints and ``train export-pretrained`` of the joint one
    (phase 6); each file read back through ``utils/torch_convert``'s
    ``convert_*`` (and the bridge) must give the checkpoint's tensors."""
    import contextlib
    import io

    from unirec_tpu_torch.cli import train_cli
    from unirec_tpu_torch.configs import ItemQFormerConfig, UserQFormerConfig
    from unirec_tpu_torch.utils import torch_convert as tc
    from unirec_tpu_torch.utils.checkpoint import load_checkpoint, restore_config
    from unirec_tpu_torch.utils.weights import (
        item_qformer_state_dict_from_flax,
        mwne_state_dict_from_flax,
        user_state_dict_from_flax,
    )

    def cli(argv):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = train_cli.main(argv)
        log(f"  train_cli {' '.join(argv[:1] + argv[-2:])}: rc {rc} in "
            f"{time.perf_counter() - t0:.1f} s | {buf.getvalue().strip()}")
        if rc != 0:
            raise AssertionError(f"(e) train_cli {argv[0]} returned {rc}")

    out = os.path.join(tmp, "exports")
    os.makedirs(out, exist_ok=True)
    item_dir = os.path.join(tmp, "item_ckpt")
    cli(["export-pth", "--checkpoint", item_dir, "--output",
         os.path.join(out, "item.pth")])
    sd, meta = load_checkpoint(item_dir)
    cfg = restore_config(meta, ItemQFormerConfig)
    ck = torch.load(os.path.join(out, "item.pth"), weights_only=False)
    same_tensors("item", item_qformer_state_dict_from_flax(
        tc.convert_item_qformer(ck["model_state_dict"], cfg)), sd)
    if ck["field_names"] != meta["field_names"]:
        raise AssertionError("(e) item: field names differ")

    user_dir = os.path.join(tmp, "user_ckpt")
    cli(["export-pth", "--stage", "user", "--checkpoint", user_dir,
         "--output", os.path.join(out, "user.pth")])
    sd, meta = load_checkpoint(user_dir)
    ucfg = restore_config(meta, UserQFormerConfig)
    ck = torch.load(os.path.join(out, "user.pth"), weights_only=False)
    same_tensors("user", user_state_dict_from_flax(
        {"user": tc.convert_user_qformer(ck["model_state_dict"], ucfg)}),
        {k: v for k, v in sd.items() if k.startswith("user.")})

    cli(["export-pth", "--stage", "mwne", "--checkpoint", mwne_dir,
         "--output", os.path.join(out, "mwne.pth")])
    sd, _ = load_checkpoint(mwne_dir)
    _, variables = tc.convert_mwne(torch.load(os.path.join(out, "mwne.pth"),
                                              weights_only=False))
    back = mwne_state_dict_from_flax(variables)
    same_tensors("mwne", {k[len("base."):]: v for k, v in back.items()
                          if k.startswith("base.")},
                 {k[len("encoder."):]: v for k, v in sd.items()
                  if k.startswith("encoder.")})

    joint_dir = os.path.join(tmp, "joint_ckpt")
    saved = os.path.join(out, "saved_model")
    cli(["export-pretrained", "--checkpoint", joint_dir, "--output", saved])
    sd, meta = load_checkpoint(os.path.join(joint_dir, "latest_model"))
    qf = restore_config({"config": meta["qformer_config"]}, ItemQFormerConfig)
    qsd = torch.load(os.path.join(saved, "qformer_model.bin"),
                     weights_only=True)
    same_tensors("joint q-former", item_qformer_state_dict_from_flax(
        tc.convert_item_qformer(qsd, qf)),
        {k[len("qformer."):]: v for k, v in sd.items()
         if k.startswith("qformer.")})
    adapter = torch.load(os.path.join(saved, "adapter_model.bin"),
                         weights_only=True)
    # base_model.model.layers.i.x.proj.lora_A.weight <- lora_a [in, r].T
    lora = {k.replace("base_model.model.", "base_model.").replace(
        ".lora_A.weight", ".lora_a").replace(".lora_B.weight", ".lora_b"):
        v.t() for k, v in adapter.items()}
    same_tensors("joint adapter", lora, {k: v for k, v in sd.items()
                                         if k.endswith((".lora_a", ".lora_b"))})
    with open(os.path.join(saved, "adapter_config.json")) as fh:
        acfg = json.load(fh)
    log(f"[{smi}] (e) exports: item, user and MWNE .pth and the joint "
        f"save_pretrained directory ({sorted(os.listdir(saved))}, adapter r "
        f"{acfg['r']} over {len(adapter)} tensors) read back to the "
        f"checkpoints' tensors")


# -- A9: data and sequence parallelism (phase_parallel) -------------------------
#
# The machine has one card, so the dp / sp paths are held three ways: the
# inference replicas of dp = 2 share cuda:0 in this process; two gloo ranks
# share cuda:0 (NCCL refuses two ranks on one device), each stepping on its
# half of the global batch (or its half of the user memory at sp = 2); and a
# world-size-1 NCCL group runs the joint step through the same dp code.  No
# figure here is a multi-card scaling figure.

PAR_CASES = ("joint", "item", "user", "user_sp")
PAR_STEPS = 2
PAR_TIMEOUT_S = 600.0


def par_mesh(case: str, ranks: int):
    """The MeshConfig of a training case: one rank, dp over the ranks, or
    (user_sp) sp over them."""
    from unirec_tpu_torch.configs import MeshConfig

    if ranks == 1:
        return MeshConfig(dp=1)
    return MeshConfig(dp=1, sp=ranks) if case == "user_sp" else MeshConfig(
        dp=ranks)


def par_counters(case: str) -> dict:
    return (train_launches() if case == "joint" else item_counters()
            if case == "item" else user_counters())


def par_inputs(tmp: str) -> dict:
    """What every process builds its cases' batches from (written by the
    parent: the joint samples, the user histories, the item rows)."""
    from unirec_tpu_torch.configs import Qwen3Config
    from unirec_tpu_torch.data.cache import FieldEmbeddingCache

    cache = FieldEmbeddingCache.load(os.path.join(tmp, "cache"))
    joint = write_train_files(os.path.join(tmp, "par"), cache,
                              Qwen3Config().hidden_size)["data"]
    user = write_user_files(os.path.join(tmp, "par"), cache)
    rng = np.random.default_rng(SEED + 21)
    item = [(rng.integers(0, len(cache), (ITEM_BATCH, 2)).astype(np.int32),
             rng.integers(0, len(cache), ITEM_BATCH).astype(np.int32))
            for _ in range(PAR_STEPS)]
    return {"joint": joint, "user": (user["histories"],
                                     user["reviews_by_item"]), "item": item}


def par_case(case: str, tmp: str, inputs: dict, mesh_cfg,
             save_grads: bool = False) -> dict:
    """One training case at full width on cuda:0: the trainer under
    ``mesh_cfg``, PAR_STEPS steps on the same global batches in every
    process (dropout off), with the first step's (reduced) gradients, each
    step's loss, the kernels' launches over the steps, the second step's ms
    and a SHA-256 of the trainable parameters after the steps."""
    import dataclasses
    import hashlib

    from unirec_tpu_torch.configs import (
        JointModelConfig,
        LoRAConfig,
        OptimizerConfig,
        Qwen3Config,
        TrainConfig,
        UserQFormerConfig,
    )
    from unirec_tpu_torch.data.cache import FieldEmbeddingCache
    from unirec_tpu_torch.data.tokenizer import HashTokenizer
    from unirec_tpu_torch.inference.qformer_inference import QFormerInference
    from unirec_tpu_torch.models.item_qformer import ItemQFormer
    from unirec_tpu_torch.train import item_qformer as it
    from unirec_tpu_torch.train import joint as jt
    from unirec_tpu_torch.train import user_qformer as ut

    cfg, sd, _ = QFormerInference.read_checkpoint(os.path.join(tmp, "ckpt"))
    cache = FieldEmbeddingCache.load(os.path.join(tmp, "cache"))
    opt = OptimizerConfig(learning_rate=1e-4, warmup_steps=0,
                          max_grad_norm=1.0)
    if case == "joint":
        qwen, jc = Qwen3Config(flash_vjp_attention=True), JointModelConfig()
        trainer = jt.JointTrainer(
            qwen, dataclasses.replace(cfg, dropout=0.0), jc,
            lora=LoRAConfig(dropout=0.0), dtype="bfloat16", bf16_base=True,
            train_config=TrainConfig(batch_size=TRAIN_BATCH, optimizer=opt,
                                     seed=SEED, mesh=mesh_cfg),
            device="cuda")
        state = trainer.init_state(qformer_params=sd)
        ds = jt.JointDataset(
            inputs["joint"]["train"], inputs["joint"]["emb"],
            HashTokenizer(qwen.vocab_size, jc.num_history_items,
                          jc.num_query_tokens_per_item),
            inputs["joint"]["items"], cache, jc, max_negatives=TRAIN_NEG,
            item_emb_dim=qwen.hidden_size)
        batches = [ds.batch(np.arange(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH))
                   for i in range(PAR_STEPS)]
        step = jt.make_joint_train_step(state.model, return_grads=True,
                                        seed=SEED, mesh=trainer.mesh)
    elif case == "item":
        icfg = dataclasses.replace(cfg, fused_training=True, dropout=0.0)
        trainer = it.ItemQFormerTrainer(
            icfg, TrainConfig(batch_size=ITEM_BATCH, optimizer=opt, seed=SEED,
                              mesh=mesh_cfg),
            dtype="bfloat16", fused_reference_forwards=True,
            fused_precision="int8", device="cuda")
        state = trainer.init_state(params=sd)
        batches = [trainer.gather_batch(cache, pairs, neg)
                   for pairs, neg in inputs["item"]]
        step = it.make_train_step(state.model, return_grads=True, seed=SEED,
                                  fused_reference_config=icfg,
                                  fused_precision="int8", mesh=trainer.mesh)
    else:
        kernels = case == "user"
        uc = UserQFormerConfig(
            num_item_tokens_to_predict=cfg.num_query_tokens,
            input_embedding_dim=cfg.hidden_size, dropout=0.0,
            flash_training=kernels, fused_training=kernels,
            sequence_parallel=mesh_cfg.sp > 1)
        trainer = ut.UserQFormerTrainer(
            uc, TrainConfig(batch_size=USER_BATCH, optimizer=opt, seed=SEED,
                            mesh=mesh_cfg),
            USER_SEQ, dtype="bfloat16", device="cuda")
        iq = ItemQFormer(cfg, device="cuda")
        iq.load_state_dict(sd)
        tokens = ut.precompute_item_tokens(iq, cache)
        del iq
        histories, by_item = inputs["user"]
        samples = ut.build_sliding_window_samples(histories,
                                                  max_seq_len=USER_SEQ)
        ts_map = ut.build_timestamp_map(by_item)
        order = np.random.default_rng(SEED + 5).permutation(len(samples))
        batches = [trainer.make_batch(samples, order[i * USER_BATCH:
                                                     (i + 1) * USER_BATCH],
                                      tokens, cache, ts_map)
                   for i in range(PAR_STEPS)]
        del tokens
        state = trainer.init_state()
        step = ut.make_train_step(state.model, return_grads=True, seed=SEED,
                                  mesh=trainer.mesh)
    counters = par_counters(case)
    for fn in counters.values():
        fn.launches = 0
    losses, ms, grads = [], [], None
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(m["loss"].item())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            grads = {n: g.detach() for n, g in m["grads"].items()}
        del m
    launches = {n: fn.launches for n, fn in counters.items()}
    digest = hashlib.sha256()
    for name, p in state.model.named_parameters():
        if p.requires_grad:
            digest.update(name.encode())
            digest.update(p.detach().float().cpu().numpy().tobytes())
    out = {"losses": losses, "ms": ms[-1], "launches": launches,
           "hash": digest.hexdigest()}
    if save_grads:
        out["grads"] = {n: g.to("cpu", torch.bfloat16) for n, g in
                        grads.items()}
    if case == "joint" and trainer.mesh is not None:
        from unirec_tpu_torch.parallel.mesh import all_reduce_sum

        leaves = list(grads.values())
        all_reduce_sum(leaves)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            all_reduce_sum(leaves)
        torch.cuda.synchronize()
        out["allreduce_ms"] = (time.perf_counter() - t0) / 3 * 1e3
        out["allreduce_mb"] = sum(g.numel() * g.element_size()
                                  for g in leaves) / 1e6
    out["full_grads"] = grads  # dropped before anything is saved
    del state, step, batches, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def par_rank(rank: int, world: int, port: int, tmp: str) -> None:
    """A gloo rank on cuda:0 (two ranks share the card): every case under
    dp (user_sp: sp) over the world; rank 0 keeps the first step's
    gradients."""
    from unirec_tpu_torch.ops._build import load_kernels
    from unirec_tpu_torch.parallel.mesh import init_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    load_kernels()
    init_distributed("cuda:0", backend="gloo",
                     init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                     rank=rank, timeout_s=PAR_TIMEOUT_S)
    with open(os.path.join(tmp, "par", "inputs.pkl"), "rb") as fh:
        inputs = pickle.load(fh)
    results = {}
    for case in PAR_CASES:
        r = par_case(case, tmp, inputs, par_mesh(case, world),
                     save_grads=rank == 0)
        r.pop("full_grads")
        results[case] = r
    torch.save(results, os.path.join(tmp, "par", f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def par_sweep(smi: str, tmp: str) -> dict:
    """The sweep at ``ItemQFormerConfig()``, batch 4096, bf16 and int8: dp = 2
    over [cuda:0, cuda:0] against dp = 1 on 8,192 items (two batches)."""
    from unirec_tpu_torch.configs import MeshConfig
    from unirec_tpu_torch.data.cache import FieldEmbeddingCache
    from unirec_tpu_torch.inference.qformer_inference import QFormerInference
    from unirec_tpu_torch.parallel.mesh import make_mesh

    cache = FieldEmbeddingCache.load(os.path.join(tmp, "cache"))
    emb, mask = cache.gather(cache.item_ids[:2 * SWEEP_BATCH])
    mesh = make_mesh(MeshConfig(dp=2), ["cuda:0", "cuda:0"])
    out = {}
    for precision in ("bf16", "int8"):
        names = ("b1", "b2", "b3") if precision == "bf16" else ("b4", "b5",
                                                                "b6")
        counters = {k: v for k, v in item_counters().items() if k in names}
        got, rate, launches = {}, {}, {}
        for dp, m in ((1, None), (2, mesh)):
            inf = QFormerInference(os.path.join(tmp, "ckpt"), device="cuda",
                                   batch_size=SWEEP_BATCH, mesh=m,
                                   precision=precision)
            inf.query_tokens_from_embeddings(emb[:SWEEP_BATCH],
                                             mask[:SWEEP_BATCH])  # warm
            for fn in counters.values():
                fn.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got[dp] = inf.query_tokens_from_embeddings(emb, mask)
            torch.cuda.synchronize()
            rate[dp] = len(emb) / (time.perf_counter() - t0)
            launches[dp] = {n: fn.launches for n, fn in counters.items()}
            del inf
        diff = float(np.abs(got[2] - got[1]).max())
        exact = bool(np.array_equal(got[2], got[1]))
        # two batches; at dp = 2 each is two shards of 2,048 items
        want = {n: c * 2 for n, c in launches[1].items()}
        log(f"[{smi}] dp sweep {precision}, {len(emb)} items at batch "
            f"{SWEEP_BATCH}: dp=2 over [cuda:0, cuda:0] against dp=1 max|d| "
            f"{diff:.3e} (gate {BLOCK_ATOL}), bit for bit: {exact}; items/s "
            f"dp=1 {rate[1]:.0f}, dp=2 {rate[2]:.0f} (one card, not a "
            f"scaling figure); launches dp=1 {launches[1]}, dp=2 "
            f"{launches[2]}")
        if not (diff <= BLOCK_ATOL and np.isfinite(got[2]).all()
                and launches[2] == want and all(launches[1].values())):
            raise AssertionError(f"the dp sweep ({precision}) fails its "
                                 f"checks")
        out[precision] = {"max_abs": diff, "bit_for_bit": exact,
                          "items_per_s": rate, "launches": launches[2]}
    return out


def phase_parallel_serve(smi: str, rec, histories) -> dict:
    """Serving at dp = 2 over [cuda:0, cuda:0] against dp = 1 on the serving
    stack: the float32 catalog (K1, K2), the int8 catalog (B11) and int8
    (b) (merged LoRA, B9a / B9b / B8).  User rows at cosine >= 0.9999, ids
    equal but for near-ties: a pick that differs must score, under dp = 1's
    user vector, within K2_TIE plus the largest difference of the two user
    vectors of dp = 1's pick (a cosine moves by at most that)."""
    from unirec_tpu_torch.configs import MeshConfig
    from unirec_tpu_torch.ops.flash_causal import flash_causal_attention
    from unirec_tpu_torch.ops.fused_qwen3_int8 import qkv_int8, swiglu_mlp_int8
    from unirec_tpu_torch.ops.int8_matmul import int8_linear
    from unirec_tpu_torch.ops.quantization import retrieve_top_k_int8
    from unirec_tpu_torch.ops.ranking import retrieve_top_k
    from unirec_tpu_torch.parallel.mesh import make_mesh
    from unirec_tpu_torch.serving.recommender import Recommender

    mesh = make_mesh(MeshConfig(dp=2), ["cuda:0", "cuda:0"])
    catalog = dict(zip(rec.catalog_ids, rec.catalog))
    kinds = {"f32": ({}, (flash_causal_attention, retrieve_top_k)),
             "int8_catalog": ({"quantize_catalog": True},
                              (flash_causal_attention, retrieve_top_k_int8)),
             "int8_b": ({"precision": "int8", "merge_lora": True},
                        (qkv_int8, swiglu_mlp_int8, int8_linear,
                         retrieve_top_k))}
    out = {}
    for kind, (kw, kernels) in kinds.items():
        recs = [Recommender(rec.model, rec.tokenizer, rec.item_dict,
                            rec.cache, catalog, batch_size=BATCH, mesh=m,
                            **kw) for m in (None, mesh)]
        users = [r.encode_users(histories) for r in recs]
        answers = [recs[0].recommend(histories, k=SERVE_K)]
        for fn in kernels:
            fn.launches = 0
        answers.append(recs[1].recommend(histories, k=SERVE_K))
        launches = {fn.__name__: fn.launches for fn in kernels}
        cos = float(((users[0] * users[1]).sum(1) / (
            np.linalg.norm(users[0], axis=1)
            * np.linalg.norm(users[1], axis=1))).min())
        du = float(np.abs(users[0] - users[1]).max())
        cat = recs[0].catalog / np.linalg.norm(recs[0].catalog, axis=1,
                                               keepdims=True)
        index = {iid: j for j, iid in enumerate(recs[0].catalog_ids)}
        swaps, worst = 0, 0.0
        for u, a1, a2 in zip(users[0], *answers):
            for r1, r2 in zip(a1, a2):
                if r1.item_id != r2.item_id:
                    swaps += 1
                    gap = abs(float(cat[index[r2.item_id]] @ u) - r1.score)
                    worst = max(worst, gap)
        tie = K2_TIE + 2 * du
        log(f"[{smi}] dp serving {kind}: dp=2 over [cuda:0, cuda:0] against "
            f"dp=1 on {len(histories)} users, min user cosine {cos:.7f} "
            f"(gate {KERNEL_COS}), max|d u| {du:.3e}, bit for bit "
            f"{bool(np.array_equal(users[0], users[1]))}; {swaps} id swaps, "
            f"worst score gap {worst:.3e} (near-tie bound {tie:.3e}); dp=2 "
            f"launches {launches}")
        if not (cos >= KERNEL_COS and worst <= tie
                and all(launches.values())):
            raise AssertionError(f"dp serving {kind} fails its checks")
        out[kind] = {"cos": cos, "swaps": swaps, "launches": launches}
        del recs
        gc.collect()
        torch.cuda.empty_cache()
    return out


def par_compare(case: str, ref: dict, got: list) -> None:
    """A case's ranks against its one-rank run (phase 6's gates): losses
    within STEP_LOSS_REL, every leaf's gradient at cosine >= STEP_GRAD_COS
    but the noise leaves, the ranks' parameters bit for bit equal and each
    rank's launches the one-rank run's."""
    rel = max(abs(a - b) / abs(b) for r in got
              for a, b in zip(r["losses"], ref["losses"]))
    g = {n: t.double() for n, t in got[0]["grads"].items()}
    want = {n: t.double() for n, t in ref["grads"].items()}
    noise = noise_leaves({n: t.float() for n, t in ref["full_grads"].items()})
    cos = {n: c for n, c in grad_cosines(g, want).items() if n not in noise}
    worst = min(cos, key=cos.get)
    same = len({r["hash"] for r in got}) == 1
    log(f"dp {case}: losses {[r['losses'] for r in got]} vs one rank "
        f"{ref['losses']} (max rel {rel:.2e}, tol {STEP_LOSS_REL:g}); "
        f"{len(cos)} leaves, min gradient cosine {cos[worst]:.6f} ({worst}, "
        f"tol {STEP_GRAD_COS}), {len(noise)} noise leaves; ranks' parameters "
        f"bit for bit equal: {same}; launches per rank "
        f"{[r['launches'] for r in got]}, one rank {ref['launches']}")
    if not (rel <= STEP_LOSS_REL and cos[worst] >= STEP_GRAD_COS and same
            and all(r["launches"] == ref["launches"] for r in got)):
        raise AssertionError(f"the dp {case} step disagrees with one rank")


def phase_parallel(smi: str, tmp: str) -> dict:
    """dp / sp on one card (see the section's comment): the sweep, the
    training cases on one rank, on a world-size-1 NCCL group (the joint step
    bit for bit the plain one) and on two gloo ranks sharing cuda:0, then
    the refusal of ``train joint --dp 2`` on this one-card machine."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from unirec_tpu_torch.configs import MeshConfig
    from unirec_tpu_torch.parallel.mesh import free_port, init_distributed

    t_phase = time.perf_counter()
    sweep = par_sweep(smi, tmp)
    os.makedirs(os.path.join(tmp, "par"), exist_ok=True)
    inputs = par_inputs(tmp)
    with open(os.path.join(tmp, "par", "inputs.pkl"), "wb") as fh:
        pickle.dump(inputs, fh)
    refs = {case: par_case(case, tmp, inputs, par_mesh(case, 1),
                           save_grads=True) for case in PAR_CASES}

    # the world-size-1 NCCL group through the same dp code
    port = free_port()
    init_distributed("cuda:0", init_method=f"tcp://127.0.0.1:{port}",
                     world_size=1, rank=0, timeout_s=PAR_TIMEOUT_S)
    try:
        nccl = par_case("joint", tmp, inputs, MeshConfig(dp=1))
    finally:
        dist.destroy_process_group()
    plain = refs["joint"]
    exact = (nccl["losses"] == plain["losses"]
             and nccl["hash"] == plain["hash"] and all(
                 torch.equal(nccl["full_grads"][n], g)
                 for n, g in plain["full_grads"].items()))
    log(f"[{smi}] joint step on a world-size-1 NCCL group: bit for bit the "
        f"plain step's: {exact}; ms per step plain {plain['ms']:.1f}, NCCL "
        f"world 1 {nccl['ms']:.1f}, the gradient all-reduce "
        f"({nccl['allreduce_mb']:.0f} MB) {nccl['allreduce_ms']:.2f} ms (one "
        f"card, not a scaling figure)")
    if not exact:
        raise AssertionError("the world-size-1 NCCL joint step is not the "
                             "plain step bit for bit")
    del nccl
    gc.collect()
    torch.cuda.empty_cache()

    # two gloo ranks sharing cuda:0
    t0 = time.perf_counter()
    ctx = mp.start_processes(par_rank, args=(2, free_port(), tmp), nprocs=2,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + PAR_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError("the two gloo ranks timed out")
    got = [torch.load(os.path.join(tmp, "par", f"rank{r}.pt"),
                      weights_only=False) for r in range(2)]
    log(f"two gloo ranks on cuda:0: {time.perf_counter() - t0:.1f} s, start "
        f"and builds included")
    for case in PAR_CASES:
        par_compare(case, refs[case], [g[case] for g in got])
    ranks_ms = {case: [g[case]["ms"] for g in got] for case in PAR_CASES}
    log(f"[{smi}] ms per step (second step, host clock, synced): one rank "
        f"{ {c: round(refs[c]['ms'], 1) for c in PAR_CASES} }, each of two "
        f"gloo ranks sharing the card {ranks_ms}; the joint gradient "
        f"all-reduce over gloo ({got[0]['joint']['allreduce_mb']:.0f} MB) "
        f"{got[0]['joint']['allreduce_ms']:.1f} ms (one card, not a scaling "
        f"figure)")
    del refs
    gc.collect()
    torch.cuda.empty_cache()

    # the refusal: two ranks on a one-card machine
    cmd = [sys.executable, "-m", "unirec_tpu_torch", "train", "joint",
           "--train-data", "x", "--val-data", "x", "--item-emb", "x",
           "--item-dict", "x", "--qformer-checkpoint", "x", "--cache-dir",
           "x", "--dp", "2"]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    want = f"needs 2 cards, have {torch.cuda.device_count()}"
    log(f"`train joint --dp 2` on this machine: exit {res.returncode}, "
        f"{res.stderr.strip().splitlines()[-1] if res.stderr else ''}")
    if res.returncode == 0 or want not in res.stderr:
        raise AssertionError("train joint --dp 2 was not refused")
    log(f"phase_parallel: {time.perf_counter() - t_phase:.1f} s")
    return {"sweep": sweep, "ranks_ms": ranks_ms}


# -- A9: tensor and pipeline parallelism (phase_tp_pp) ------------------------
#
# The joint step at full width (Qwen3Config(), batch 8, L 512, 10 negatives,
# no remat, dropout 0, bf16 with the frozen base in bf16; the plain attention
# under autograd, since tp and pp refuse flash-VJP) on one rank, at tp = 2
# and at pp = 2 (M = 2) over two gloo ranks that share cuda:0, and the tp and
# pp code on a world-size-1 NCCL group.  No figure here is a multi-card
# scaling figure.

TPP_CASES = ("tp", "pp")
TPP_STEPS, TPP_MICROBATCHES = 2, 2
TPP_LOSS_REL, TPP_USER_COS = 1e-3, 0.99999
TPP_LOCAL = dict(B=8, L=512, HQ=8, HKV=4, HD=128)  # K1 at tp = 2's heads


def tpp_case(case: str, tmp: str, inputs: dict, save_grads: bool = False
             ) -> dict:
    """One layout of the joint step on cuda:0: "one" (one rank, or the
    plain step of a world of one), "tp" (tp = 2 over the world), "pp" (pp =
    2, M = 2 over the world) or "pp1" (the pipeline's code at pp = 1, one
    microbatch).  TPP_STEPS steps on the same global batches; each step's
    loss and ms, the first step's gradients (tp: gathered from the shards;
    pp: this stage's, under its local names), a SHA-256 of the trainable
    parameters (tp / pp: of the replicated ones), peak memory; the eval
    forward's user vectors and K1 launches (not under pp, whose evaluation
    is the merged tree's one-rank forward); the collectives' ms."""
    import dataclasses
    import hashlib

    from unirec_tpu_torch.configs import (
        JointModelConfig,
        LoRAConfig,
        MeshConfig,
        OptimizerConfig,
        Qwen3Config,
        TrainConfig,
    )
    from unirec_tpu_torch.data.cache import FieldEmbeddingCache
    from unirec_tpu_torch.data.tokenizer import HashTokenizer
    from unirec_tpu_torch.inference.qformer_inference import QFormerInference
    from unirec_tpu_torch.ops.flash_causal import flash_causal_attention
    from unirec_tpu_torch.parallel.tensor import (
        all_reduce_,
        gather_state_dict,
        tp_split,
    )
    from unirec_tpu_torch.train import joint as jt

    cfg, sd, _ = QFormerInference.read_checkpoint(os.path.join(tmp, "ckpt"))
    cache = FieldEmbeddingCache.load(os.path.join(tmp, "cache"))
    qwen, jc = Qwen3Config(), JointModelConfig()
    pp = {"pp": 2, "pp1": 1}.get(case)
    world = (torch.distributed.get_world_size()
             if torch.distributed.is_initialized() else 1)
    mesh = (MeshConfig(dp=1, tp=2) if case == "tp"
            else MeshConfig(dp=world))
    trainer = jt.JointTrainer(
        qwen, dataclasses.replace(cfg, dropout=0.0), jc,
        lora=LoRAConfig(dropout=0.0), dtype="bfloat16", bf16_base=True,
        train_config=TrainConfig(
            batch_size=TRAIN_BATCH, seed=SEED, mesh=mesh,
            optimizer=OptimizerConfig(learning_rate=1e-4, max_grad_norm=1.0)),
        device="cuda")
    torch.cuda.reset_peak_memory_stats()
    state = trainer.init_state(qformer_params=sd)
    ds = jt.JointDataset(
        inputs["joint"]["train"], inputs["joint"]["emb"],
        HashTokenizer(qwen.vocab_size, jc.num_history_items,
                      jc.num_query_tokens_per_item),
        inputs["joint"]["items"], cache, jc, max_negatives=TRAIN_NEG,
        item_emb_dim=qwen.hidden_size)
    batches = [ds.batch(np.arange(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH))
               for i in range(TPP_STEPS)]
    out = {}
    if pp is None:  # the eval forward, sharded like training under tp
        out["user"], out["k1_launches"] = tpp_eval(trainer, state,
                                                   batches[0])
        step = jt.make_joint_train_step(state.model, return_grads=True,
                                        seed=SEED, mesh=trainer.mesh)
    else:
        pt = jt.PipelinedJointTrainer(trainer, pp=pp,
                                      num_microbatches=TPP_MICROBATCHES
                                      if pp > 1 else 1)
        state = pt.init_trainable(state)
        step = jt.make_pipeline_train_step(state.model, pt.mesh,
                                           return_grads=True, seed=SEED)
        out["stage"] = pt.mesh.stage
        out["per"] = state.model.base_model.layers_per_stage
    losses, ms, grads = [], [], None
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(m["loss"].item())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            grads = m["grads"]
            if case == "tp":
                grads = gather_state_dict(grads, trainer.tp)
        del m
    out.update(losses=losses, ms=ms[-1],
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    digest = hashlib.sha256()
    for name, p in state.model.named_parameters():
        replicated = (tp_split(name) is None if case == "tp" else
                      not name.startswith("base_model.layers.")
                      if case == "pp" else True)
        if p.requires_grad and replicated:
            digest.update(name.encode())
            digest.update(p.detach().float().cpu().numpy().tobytes())
    out["hash"] = digest.hexdigest()
    if save_grads:
        out["grads"] = {n: g.to("cpu", torch.bfloat16)
                        for n, g in grads.items()}
    out["full_grads"] = grads  # dropped before anything is saved
    if case == "tp":  # a row layer's output, reduced over the tp group
        act = torch.randn(TRAIN_BATCH * jc.max_length, qwen.hidden_size,
                          device="cuda").to(torch.bfloat16)
        all_reduce_(act, trainer.tp.group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            all_reduce_(act, trainer.tp.group)
        torch.cuda.synchronize()
        out["allreduce_ms"] = (time.perf_counter() - t0) / 5 * 1e3
    elif pp == 2:  # one microbatch's activations from stage 0 to stage 1
        base = state.model.base_model
        act = torch.randn(TRAIN_BATCH // TPP_MICROBATCHES, jc.max_length,
                          qwen.hidden_size, device="cuda").to(torch.bfloat16)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            if base.pipe.stage == 0:
                base._send(act, base.pipe.next_rank)
            else:
                base._recv(act, base.pipe.prev_rank)
        torch.cuda.synchronize()
        out["p2p_ms"] = (time.perf_counter() - t0) / 5 * 1e3
    del state, step, batches, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tpp_eval(trainer, state, batch) -> tuple:
    """The eval forward's user vectors on ``batch`` ({dtype: [B, D] on the
    host}) and K1's launches ({dtype: count}): at the trainer's bf16, and
    at float32 over the same tensors (the bf16 base cast at use), where
    rounding cannot hide a tp fault; K1 runs in both."""
    from unirec_tpu_torch.models.joint import MultiModalQwenEmbedding
    from unirec_tpu_torch.ops.flash_causal import flash_causal_attention
    from unirec_tpu_torch.train import joint as jt

    b = jt.batch_to_device(batch, torch.device("cuda"))
    users, launches = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        flash_causal_attention.launches = 0
        with trainer.evaluating(state) as model:
            if dtype == torch.float32:
                model = MultiModalQwenEmbedding(
                    trainer.qwen_config, trainer.qformer_config,
                    trainer.joint_config, trainer.lora, device="meta",
                    dtype=dtype, param_dtype=dtype, tp=trainer.tp).eval()
                model.load_state_dict(state.model.state_dict(), assign=True)
            user = model(b["input_ids"], b["attention_mask"],
                         b["history_field_embeddings"],
                         b["history_attention_mask"])
        torch.cuda.synchronize()
        users[dtype] = user.float().cpu()
        launches[dtype] = flash_causal_attention.launches
    return users, launches


def tpp_rank(rank: int, world: int, port: int, tmp: str) -> None:
    """A gloo rank on cuda:0 (two ranks share the card): the tp and pp
    cases over the world; every rank keeps its first step's gradients (pp:
    its stage's)."""
    from unirec_tpu_torch.ops._build import load_kernels
    from unirec_tpu_torch.parallel.mesh import init_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    load_kernels()
    init_distributed("cuda:0", backend="gloo",
                     init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                     rank=rank, timeout_s=PAR_TIMEOUT_S)
    with open(os.path.join(tmp, "par", "inputs.pkl"), "rb") as fh:
        inputs = pickle.load(fh)
    results = {}
    for case in TPP_CASES:
        r = tpp_case(case, tmp, inputs, save_grads=rank == 0 or case == "pp")
        r.pop("full_grads")
        results[case] = r
    torch.save(results, os.path.join(tmp, "par", f"tpp_rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def tpp_merged_grads(got: list) -> dict:
    """The pp ranks' gradients under the joint model's names."""
    out = {}
    prefix = "base_model.layers."
    for r in got:
        for name, g in r["grads"].items():
            if name.startswith(prefix):
                j, _, leaf = name[len(prefix):].partition(".")
                name = f"{prefix}{r['stage'] * r['per'] + int(j)}.{leaf}"
            out[name] = g
    return out


def tpp_compare(case: str, ref: dict, got: list, grads: dict) -> None:
    """A layout's ranks against the one-rank step: losses within
    TPP_LOSS_REL, every leaf's gradient at cosine >= STEP_GRAD_COS but the
    noise leaves, the ranks' replicated parameters bit for bit equal."""
    rel = max(abs(a - b) / abs(b) for r in got
              for a, b in zip(r["losses"], ref["losses"]))
    want = {n: t.double() for n, t in ref["grads"].items()}
    noise = noise_leaves({n: t.float() for n, t in ref["full_grads"].items()})
    cos = {n: c for n, c in grad_cosines(
        {n: t.double() for n, t in grads.items()}, want).items()
        if n not in noise}
    worst = min(cos, key=cos.get)
    same = len({r["hash"] for r in got}) == 1
    log(f"{case}: losses {[r['losses'] for r in got]} vs one rank "
        f"{ref['losses']} (max rel {rel:.2e}, tol {TPP_LOSS_REL:g}); "
        f"{len(cos)} leaves, min gradient cosine {cos[worst]:.6f} ({worst}, "
        f"tol {STEP_GRAD_COS}), {len(noise)} noise leaves; the ranks' "
        f"replicated parameters bit for bit equal: {same}")
    if not (rel <= TPP_LOSS_REL and cos[worst] >= STEP_GRAD_COS and same):
        raise AssertionError(f"the {case} step disagrees with one rank")


def tpp_rounding(smi: str) -> dict:
    """Where tp = 2's bf16 products part from one rank's, at
    ``Qwen3Config()``'s widths on the step's 4,096 rows (random bf16
    operands, weights at 1/sqrt(fan-in)): each column layer's half (the
    first N/2 output features, as rank 0 holds them) against the same
    columns of the whole product, the share of elements that differ; each
    row layer as two bf16 partials over K/2, summed and rounded again (a
    gloo or NCCL reduce of two ranks), against the one-rank product, the
    share that differ; and the relative error of each form, and of the
    float32 product rounded once to bf16, to the float64 product."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED + 29)
    rows = TRAIN_BATCH * 512

    def operands(n_out, n_in):
        x = torch.randn(rows, n_in, generator=gen, device="cuda")
        w = torch.randn(n_out, n_in, generator=gen, device="cuda")
        return x.bfloat16(), (w * n_in ** -0.5).bfloat16()

    def rel(y, truth):
        return float((y.double() - truth).norm() / truth.norm())

    out = {}
    for name, n_out, n_in in (("q_proj", 2048, 1024), ("k_proj", 1024, 1024),
                              ("gate_proj", 3072, 1024)):
        x, w = operands(n_out, n_in)
        whole = F.linear(x, w)[:, :n_out // 2]
        half = F.linear(x, w[:n_out // 2])
        out[name] = {"differ": float((whole != half).float().mean())}
    for name, n_out, n_in in (("o_proj", 1024, 2048),
                              ("down_proj", 1024, 3072)):
        x, w = operands(n_out, n_in)
        k = n_in // 2
        truth = x.double() @ w.double().T
        one = F.linear(x, w)
        two = (F.linear(x[:, :k], w[:, :k]).float()
               + F.linear(x[:, k:], w[:, k:]).float()).bfloat16()
        out[name] = {"differ": float((one != two).float().mean()),
                     "rel_one": rel(one, truth), "rel_two": rel(two, truth),
                     "rel_rounded": rel(truth.float().bfloat16(), truth)}
    log(f"[{smi}] tp=2's bf16 products against one rank's (4,096 rows): "
        f"column halves, share of elements that differ "
        f"{ {n: out[n]['differ'] for n in ('q_proj', 'k_proj', 'gate_proj')} }"
        f"; row layers, two rounded partials summed: "
        f"{ {n: out[n] for n in ('o_proj', 'down_proj')} } (rel: relative "
        f"error to the float64 product; rounded: the exact product rounded "
        f"once to bf16)")
    return out


def phase_tp_pp(smi: str, tmp: str) -> dict:
    """tp and pp on one card (see the section's comment): K1 at tp = 2's
    local heads against its plain version; the joint step on one rank; the
    pipeline's and the trainer's code on a world-size-1 NCCL group (bit for
    bit the plain step); tp = 2 and pp = 2 over two gloo ranks sharing
    cuda:0 against one rank (and the tp = 2 eval forward's user vectors and
    K1 launches); the refusals of ``train joint --tp 2`` and ``--pp 2`` on
    this one-card machine."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from unirec_tpu_torch.parallel.mesh import free_port, init_distributed

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    b, l, hq, hkv, hd = (TPP_LOCAL[x] for x in ("B", "L", "HQ", "HKV", "HD"))
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, _, mask = causal_inputs(gen, b, l, hq, hkv, hd, dtype,
                                         [512, 333, 200, 65, 64, 7, 1, 512])
        check_k1(*k1_error(q, k, v, mask, hq, hkv), dtype,
                 f"tp=2 local heads Hq={hq} Hkv={hkv}")
    rounding = tpp_rounding(smi)
    # the refusals, in the background while the steps run
    refusals = {}
    base = [sys.executable, "-m", "unirec_tpu_torch", "train", "joint",
            "--train-data", "x", "--val-data", "x", "--item-emb", "x",
            "--item-dict", "x", "--qformer-checkpoint", "x", "--cache-dir",
            "x"]
    for flag in ("--tp", "--pp"):
        refusals[flag] = subprocess.Popen(
            base + [flag, "2"], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    path = os.path.join(tmp, "par", "inputs.pkl")
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as fh:
            pickle.dump(par_inputs(tmp), fh)
    with open(path, "rb") as fh:
        inputs = pickle.load(fh)
    ref = tpp_case("one", tmp, inputs, save_grads=True)

    # the trainer's and the pipeline's code on a world-size-1 NCCL group
    init_distributed("cuda:0", init_method=f"tcp://127.0.0.1:{free_port()}",
                     world_size=1, rank=0, timeout_s=PAR_TIMEOUT_S)
    try:
        nccl = {case: tpp_case(case, tmp, inputs) for case in ("one", "pp1")}
    finally:
        dist.destroy_process_group()
    for case, r in nccl.items():
        exact = (r["losses"] == ref["losses"] and r["hash"] == ref["hash"]
                 and all(torch.equal(r["full_grads"][n], g)
                         for n, g in ref["full_grads"].items()))
        log(f"[{smi}] joint step ({case}) on a world-size-1 NCCL group: bit "
            f"for bit the plain step's: {exact}; ms per step plain "
            f"{ref['ms']:.1f}, here {r['ms']:.1f}")
        if not exact:
            raise AssertionError(f"the world-size-1 NCCL step ({case}) is "
                                 "not the plain step bit for bit")
    del nccl
    gc.collect()
    torch.cuda.empty_cache()

    # two gloo ranks sharing cuda:0
    t0 = time.perf_counter()
    ctx = mp.start_processes(tpp_rank, args=(2, free_port(), tmp), nprocs=2,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + PAR_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError("the two gloo ranks timed out")
    got = [torch.load(os.path.join(tmp, "par", f"tpp_rank{r}.pt"),
                      weights_only=False) for r in range(2)]
    log(f"two gloo ranks on cuda:0 (tp, then pp): "
        f"{time.perf_counter() - t0:.1f} s, start and builds included")
    tp = [g["tp"] for g in got]
    tpp_compare("tp=2", ref, tp, tp[0]["grads"])
    tpp_compare("pp=2 (M=2)", ref, [g["pp"] for g in got],
                tpp_merged_grads([g["pp"] for g in got]))

    def min_cos(a, b):
        return float(torch.nn.functional.cosine_similarity(
            a.double(), b.double(), dim=1).min())

    cos = {dtype: min(min_cos(r["user"][dtype], ref["user"][dtype])
                      for r in tp) for dtype in ref["user"]}
    # bf16's own distance from the float32 users, one rank's and tp's
    f32, b16 = torch.float32, torch.bfloat16
    off = {"one": 1 - min_cos(ref["user"][b16], ref["user"][f32]),
           "tp": max(1 - min_cos(r["user"][b16], ref["user"][f32])
                     for r in tp)}
    # bf16: tp's only extra rounding is in the row layers (the column
    # halves are the whole product's bits), whose error to the exact
    # product grows by rel_two / rel_one; if all of bf16's distance came
    # from them, tp's would be at most that ratio squared times one rank's
    ratio = max(rounding[n]["rel_two"] / rounding[n]["rel_one"]
                for n in ("o_proj", "down_proj")) ** 2
    log(f"tp=2 eval forward: min user cosine to one rank "
        f"{ {str(d): round(c, 8) for d, c in cos.items()} } (float32 gate "
        f"{TPP_USER_COS}); bf16's 1 - min cosine to one rank's float32 "
        f"users: one rank {off['one']:.3e}, tp=2 {off['tp']:.3e} (gate: "
        f"tp=2's at most {ratio:.3f} x one rank's, the row layers' error "
        f"ratio squared); K1 launches per rank "
        f"{[r['k1_launches'] for r in tp]} (one rank {ref['k1_launches']}, "
        f"gate 28 a forward)")
    if not (cos[f32] >= TPP_USER_COS and off["tp"] <= ratio * off["one"]
            and all(n == 28 for r in tp + [ref]
                    for n in r["k1_launches"].values())):
        raise AssertionError("the tp=2 eval forward fails its checks")
    log(f"[{smi}] ms per step (second step, host clock, synced): one rank "
        f"{ref['ms']:.1f}, tp=2 {[round(r['ms'], 1) for r in tp]}, pp=2 "
        f"{[round(g['pp']['ms'], 1) for g in got]}; peak GB one rank "
        f"{ref['peak_gb']:.2f}, tp=2 per rank "
        f"{[round(r['peak_gb'], 2) for r in tp]}, pp=2 per rank "
        f"{[round(g['pp']['peak_gb'], 2) for g in got]}; a row layer's "
        f"all-reduce over gloo ([4096, 1024] bf16) "
        f"{[round(r['allreduce_ms'], 2) for r in tp]} ms, a microbatch's "
        f"send/recv ([4, 512, 1024] bf16, through host memory) "
        f"{[round(g['pp']['p2p_ms'], 2) for g in got]} ms (one card, not a "
        f"scaling figure)")

    for flag, proc in refusals.items():
        _, err = proc.communicate(timeout=300)
        want = f"needs 2 cards, have {torch.cuda.device_count()}"
        log(f"`train joint {flag} 2` on this machine: exit {proc.returncode}, "
            f"{err.strip().splitlines()[-1] if err else ''}")
        if proc.returncode == 0 or want not in err:
            raise AssertionError(f"train joint {flag} 2 was not refused")
    log(f"phase_tp_pp: {time.perf_counter() - t_phase:.1f} s")
    return {"ms": {"one": ref["ms"], "tp": [r["ms"] for r in tp],
                   "pp": [g["pp"]["ms"] for g in got]}}


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

    marks = [t0]

    def lap(name: str) -> None:
        """The seconds a phase took (where the run's time limit goes)."""
        marks.append(time.perf_counter())
        log(f"time: {name} {marks[-1] - marks[-2]:.1f} s, "
            f"{marks[-1] - marks[0]:.1f} s in all")

    lap("build")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    k1_times = phase_k1(gen)
    b7b = phase_b7b(gen)
    phase_head_dims(gen)
    k2_times = phase_k2(gen)
    b11_times = phase_b11(gen)
    phase_retrieval_edges(torch.Generator(device="cuda").manual_seed(SEED + 15))
    blocks = phase_blocks(gen, "bf16")
    for key, err in phase_wide_k(gen).items():
        blocks[key]["err"] = max(blocks[key]["err"], err)
    blocks.update(phase_blocks(gen, "int8"))
    # the phases added since draw from their own generator, so that every
    # other phase sees the inputs it was held to before
    new_gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    phase_int8_gemm(new_gen)
    phase_widths(new_gen)
    phase_ln_routes(torch.Generator(device="cuda").manual_seed(SEED + 13))
    b12 = phase_b12(gen)
    for key, err in phase_b12_shapes(gen).items():
        b12[key]["err"] = max(b12[key]["err"], err)
    fp32 = phase_fp32_fused(smi)
    lap("kernel phases")
    gc.collect()
    torch.cuda.empty_cache()
    flash = phase_flash_cross(gen)
    b14p = phase_b14p(gen)
    b15 = phase_b15(gen, new_gen)
    wide = phase_wide_heads(torch.Generator(device="cuda").manual_seed(
        SEED + 17))
    lap("flash cross, B14p, B15, wide heads")
    gc.collect()
    torch.cuda.empty_cache()
    qwen3_int8 = phase_qwen3_int8(gen)
    served = phase_serve(smi)
    lap("qwen3 int8, serving")
    with tempfile.TemporaryDirectory() as tmp:
        rec, histories = served.pop("stack")
        phase_entry_point(smi, rec, os.path.join(tmp, "serve"))
        gc.collect()
        torch.cuda.empty_cache()
        par_served = phase_parallel_serve(smi, rec, histories)
        lap("entry point, parallel serving")
        del rec
        gc.collect()  # the serving stacks, before the sweep's memory is read
        torch.cuda.empty_cache()
        swept = phase_sweep(smi, tmp)
        lap("sweep")
        gc.collect()
        torch.cuda.empty_cache()
        quality = phase_quality(smi)
        lap("quality")
        gc.collect()
        torch.cuda.empty_cache()
        front = phase_front_end(smi, tmp)
        lap("front end")
        gc.collect()
        torch.cuda.empty_cache()
        trained = phase_train(smi, tmp)
        lap("joint training")
        gc.collect()
        torch.cuda.empty_cache()
        item_trained = phase_item_train(smi, tmp)
        lap("item training")
        gc.collect()
        torch.cuda.empty_cache()
        user_trained = phase_user_train(smi, tmp)
        lap("user training")
        gc.collect()
        torch.cuda.empty_cache()
        # (b)-(e): the user step at 2 heads of 512, the LM head's decoding,
        # MWNE training, and the exports of phases 6-8's and (d)'s
        # checkpoints
        wide_user = phase_user_train(smi, tmp, heads=2)
        lap("user step, 2 heads, bf16")
        gc.collect()
        torch.cuda.empty_cache()
        # the same step at float32 compute, the train CLI's default: B14 in
        # the 3xTF32 cluster form in every cross layer
        wide_user32 = phase_user_train(smi, tmp, heads=2, dtype="float32")
        lap("user step, 2 heads, float32")
        gc.collect()
        torch.cuda.empty_cache()
        # C-19: the user step at one head of 1024 (B14's backward in the
        # cluster form), parity and ms per step
        one_head_user = phase_user_train(smi, tmp, heads=1, evaluate=False)
        lap("user step, 1 head")
        gc.collect()
        torch.cuda.empty_cache()
        lm = phase_lm_decode(smi)
        lap("LM decoding")
        gc.collect()
        torch.cuda.empty_cache()
        phase_exports(smi, tmp, phase_mwne(smi, tmp))
        lap("MWNE, exports")
        gc.collect()
        torch.cuda.empty_cache()
        parallel = phase_parallel(smi, tmp)
        lap("parallel")
        gc.collect()
        torch.cuda.empty_cache()
        phase_tp_pp(smi, tmp)
        lap("tp, pp")
    sweep_launches = {**swept["bf16"]["launches"], **swept["int8"]["launches"]}

    bounds = static_bounds()
    b16 = torch.bfloat16

    def row(name, source, replaces, launches, err, ms, plain_ms, bound_ms,
            bound_by, library_ms=None, **extra):
        return {"name": name, "route": "cuda",
                "source": f"unirec_tpu_torch/csrc/{source}",
                "replaces": f"unirec_tpu/ops/{replaces}", "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms, **extra}

    def retrieval_row(name, replaces, launches, err, times):
        """The 8-user (serving batch) figures, cold L2, with the warm and
        64-user ones as extra keys."""
        at8, at64 = times[BATCH], times[K2_USERS[-1]]
        return row(name, "retrieve_topk.cu", replaces, launches, err,
                   at8["ms"], at8["plain_ms"], at8["bound_ms"],
                   at8["bound_by"], users=BATCH, warm_ms=at8["warm_ms"],
                   mm_topk_ms=at8["mm_topk_ms"], **{
                       f"{key}_{K2_USERS[-1]}users": at64[key] for key in (
                           "ms", "warm_ms", "plain_ms", "mm_topk_ms",
                           "bound_ms", "bound_by")})

    k1, k1t = k1_times[b16], front["k1_text"]
    kernels = [
        row("flash_causal_fwd", "flash_causal_fwd.cu",
            "flash_causal_vjp.py:78", served["launches"]["k1"],
            served["k1_err"], k1["ms"], k1["plain_ms"], k1["bound_ms"],
            k1["bound_by"], k1["library_ms"]),
        # K1 at the text tower's shape (B 64, L 128), where the JAX package
        # runs the stock Pallas flash; launches from the text backend's run;
        # fill: the timed batch's valid tokens / (B * L)
        dict(row("flash_causal_fwd_text_tower", "flash_causal_fwd.cu", "",
                 k1t["launches"], k1t["err"], k1t["ms"], k1t["plain_ms"],
                 k1t["bound_ms"], k1t["bound_by"], k1t["library_ms"]),
             replaces="unirec_tpu/models/qwen3.py:347", fill=k1t["fill"]),
        row("flash_causal_bwd_dq", "flash_causal_bwd.cu",
            "flash_causal_vjp.py:158", trained["launches"]["b7b_dq"],
            max(b7b[b16]["errs"]["dq"], b7b[torch.float32]["errs"]["dq"]),
            **b7b[b16]["dq"]),
        row("flash_causal_bwd_dkv", "flash_causal_bwd.cu",
            "flash_causal_vjp.py:224", trained["launches"]["b7b_dkv"],
            max(b7b[b16]["errs"][n] for n in ("dk", "dv")),
            **b7b[b16]["dkv"]),
        retrieval_row("retrieve_topk", "ranking.py:118",
                      served["launches"]["k2"], served["k2_err"], k2_times),
        retrieval_row("retrieve_topk_int8", "quantization.py:78",
                      served["launches"]["b11"], served["b11_err"],
                      b11_times),
    ] + [
        row(name, "qformer_blocks.cu", f"{src}:{line}", sweep_launches[key],
            blocks[key]["err"], blocks[key]["ms"], blocks[key]["plain_ms"],
            *bounds[key], blocks[key]["library_ms"])
        for key, name, src, line in (
            ("b1", "qformer_self_block", "fused_qformer_layer.py", 119),
            ("b2", "qformer_cross_block", "fused_qformer_layer.py", 174),
            ("b3", "qformer_ffn_block", "fused_qformer_layer.py", 421),
            ("b4", "qformer_self_block_q", "fused_qformer_int8.py", 90),
            ("b5", "qformer_cross_block_q", "fused_qformer_int8.py", 140),
            ("b6", "qformer_ffn_block_q", "fused_qformer_int8.py", 193))
    ] + [
        row(name, "qformer_blocks.cu", src,
            served["int8"]["launches"][key],
            max(qwen3_int8[key]["err"], served["int8"]["errs"][key]),
            qwen3_int8[key]["ms"], qwen3_int8[key]["plain_ms"], *bounds[key],
            qwen3_int8[key]["library_ms"])
        for key, name, src in (
            ("b8", "int8_linear", "int8_matmul.py:37"),
            ("b9a", "qkv_int8", "fused_qwen3_int8.py:55"),
            ("b9b", "qwen3_swiglu_q", "fused_qwen3_int8.py:163"))
    ] + [
        # B8's fp32 form: launches from phase_quality's --int8-base run
        row("int8_linear_fp32", "qformer_blocks.cu", "int8_matmul.py:37",
            quality["b8_fp32"]["launches"], quality["b8_fp32"]["err"],
            quality["b8_fp32"]["ms"], quality["b8_fp32"]["plain_ms"],
            quality["b8_fp32"]["bound_ms"], quality["b8_fp32"]["bound_by"],
            quality["b8_fp32"]["library_ms"], activations="float32")
    ] + [
        row(name, "fused_qformer_vjp.cu", f"fused_qformer_vjp.py:{line}",
            item_trained["launches"][key], b12[key]["err"], b12[key]["ms"],
            b12[key]["plain_ms"], b12[key]["bound_ms"], b12[key]["bound_by"],
            b12[key]["library_ms"])
        for key, name, line in (
            ("b12s_fwd", "qformer_self_block_train_fwd", 133),
            ("b12s_bwd", "qformer_self_block_train_bwd", 162),
            ("b12c_fwd", "qformer_cross_block_train_fwd", 344),
            ("b12c_bwd", "qformer_cross_block_train_bwd", 383))
    ] + [
        row(name, "flash_cross.cu", replaces,
            user_trained["launches"][key], flash[key]["err"],
            flash[key]["ms"], flash[key]["plain_ms"], flash[key]["bound_ms"],
            flash[key]["bound_by"], flash[key]["library_ms"],
            **{k: v for k, v in flash[key].items() if k == "path_ms"})
        for key, name, replaces in (
            ("b13", "flash_cross_attention", "attention.py:163"),
            ("b14_fwd", "flash_cross_proj_fwd", "flash_vjp.py:362"),
            ("b14_bwd", "flash_cross_proj_bwd", "flash_vjp.py:426"))
    ] + [
        row(name, "flash_cross.cu", replaces, b14p[key]["launches"],
            b14p[key]["err"], b14p[key]["ms"], b14p[key]["plain_ms"],
            b14p[key]["bound_ms"], b14p[key]["bound_by"],
            b14p[key]["library_ms"],
            **{k: v for k, v in b14p[key].items() if k == "path_ms"})
        for key, name, replaces in (
            ("b14p_fwd", "flash_cross_attention_vjp_fwd", "flash_vjp.py:51"),
            ("b14p_bwd", "flash_cross_attention_vjp_bwd", "flash_vjp.py:113"))
    ] + [
        # the fp32 forms: launches from phase_fp32_fused's engine run (B1-B6)
        # and its autograd run (B12); no caller in either package
        row(name, source, replaces, fp32[key]["launches"], fp32[key]["err"],
            fp32[key]["ms"], fp32[key]["plain_ms"], fp32[key]["bound_ms"],
            fp32[key]["bound_by"], fp32[key]["library_ms"],
            activations="float32")
        for key, name, source, replaces in (
            ("b1", "qformer_self_block_fp32", "qformer_blocks.cu",
             "fused_qformer_layer.py:119"),
            ("b2", "qformer_cross_block_fp32", "qformer_blocks.cu",
             "fused_qformer_layer.py:174"),
            ("b3", "qformer_ffn_block_fp32", "qformer_blocks.cu",
             "fused_qformer_layer.py:421"),
            ("b4", "qformer_self_block_q_fp32", "qformer_blocks.cu",
             "fused_qformer_int8.py:90"),
            ("b5", "qformer_cross_block_q_fp32", "qformer_blocks.cu",
             "fused_qformer_int8.py:140"),
            ("b6", "qformer_ffn_block_q_fp32", "qformer_blocks.cu",
             "fused_qformer_int8.py:193"),
            ("b12s_fwd", "qformer_self_block_train_fwd_fp32",
             "fused_qformer_vjp.cu", "fused_qformer_vjp.py:133"),
            ("b12s_bwd", "qformer_self_block_train_bwd_fp32",
             "fused_qformer_vjp.cu", "fused_qformer_vjp.py:162"),
            ("b12c_fwd", "qformer_cross_block_train_fwd_fp32",
             "fused_qformer_vjp.cu", "fused_qformer_vjp.py:344"),
            ("b12c_bwd", "qformer_cross_block_train_bwd_fp32",
             "fused_qformer_vjp.cu", "fused_qformer_vjp.py:383"))
    ] + [
        row("packed_item_attention", "packed_attention.cu",
            "packed_attention.py:39", b15["launches"], b15["err"],
            **{k: v for k, v in b15["timed"][0].items() if k != "F"})
    ]

    # the chunked form at head dim 512 ((a); bf16 figures, the fp32, hd-320
    # and hd-768 ones as extra keys, with the form each ran at each head
    # dim; the cross rows' hd-1024 figures from one head of 1024, B13's
    # also at 1536): K1 / B7b launches from their entry point's run in (a),
    # B13 / B14 from the 2-head user step and evaluation of (b), B14p from
    # its entry point's run in (a)
    causal = wide["causal"]
    one = wide["one_head"]
    scalar = one["hd2304"]
    timed = ("ms", "plain_ms", "bound_ms", "library_ms")
    for key, row_name, src, replaces in (
            ("k1", "flash_causal_fwd_hd512", "flash_causal_fwd.cu",
             "flash_causal_vjp.py:78"),
            ("dq", "flash_causal_bwd_dq_hd512", "flash_causal_bwd.cu",
             "flash_causal_vjp.py:158"),
            ("dkv", "flash_causal_bwd_dkv_hd512", "flash_causal_bwd.cu",
             "flash_causal_vjp.py:224")):
        at = causal[(512, b16)]
        errs = ({"k1": ("o",), "dq": ("dq",), "dkv": ("dk", "dv")}[key])
        err = max(causal[(hd, dt)]["errs"][e] for hd in WIDE_HDS
                  for dt in (torch.float32, b16) for e in errs)
        launches = sum(causal[(512, dt)]["launches"][
            ("k1", "dq", "dkv").index(key)] for dt in (torch.float32, b16))
        err = max(err, *(causal[(WIDE_BF16_HD, b16)]["errs"][e]
                         for e in errs), *(scalar["errs"][e] for e in errs))
        kernels.append(row(
            row_name, src, replaces, launches, err, **at[key], head_dim=512,
            sdpa_backend=at["sdpa_backend"],
            **{f"{k}_fp32": v for k, v in causal[(512, torch.float32)][key]
               .items() if k in timed},
            **{f"{k}_hd{hd}": v for hd in (320, WIDE_BF16_HD)
               for k, v in causal[(hd, b16)][key].items() if k in timed},
            forms={**{hd: causal[(hd, b16)]["forms"][key]
                      for hd in (*WIDE_HDS, WIDE_BF16_HD)},
                   WIDE_SCALAR_HD: scalar["forms"][
                       {"k1": "fwd", "dq": "rows", "dkv": "keys"}[key]]},
            **({"kernel": "chunk_bwd_keys_tc"} if key == "dkv" else {})))
    for key, row_name, replaces, launches in (
            ("b13", "flash_cross_attention_hd512", "attention.py:163",
             wide_user["launches"]["b13"]),
            ("b14_fwd", "flash_cross_proj_fwd_hd512", "flash_vjp.py:362",
             wide_user["launches"]["b14_fwd"]),
            ("b14_bwd", "flash_cross_proj_bwd_hd512", "flash_vjp.py:426",
             wide_user["launches"]["b14_bwd"]),
            ("b14p_fwd", "flash_cross_attention_vjp_fwd_hd512",
             "flash_vjp.py:51", None),
            ("b14p_bwd", "flash_cross_attention_vjp_bwd_hd512",
             "flash_vjp.py:113", None)):
        at, at32 = wide[b16][key], wide[torch.float32][key]
        at1 = one["hd1024"][key]
        way = "fwd" if key == "b13" or key.endswith("_fwd") else "bwd"
        extra = {f"{k}_hd{WIDE_ONE_HEAD_HD}": at1[k] for k in timed}
        extra["forms"] = {512: "tensor_cores",
                          WIDE_ONE_HEAD_HD: one["hd1024"]["forms"][way],
                          WIDE_SCALAR_HD: scalar["forms"][
                              "fwd" if way == "fwd" else "rows"]}
        if key == "b13":
            extra.update({f"{k}_hd{WIDE_B13_HD}": one["b13_hd1536"][k]
                          for k in (*timed, "ms_unsplit", "splits")})
            extra["forms"][WIDE_B13_HD] = one["b13_hd1536"]["form"]
        if launches is not None:  # B14 in the 1-head user step
            extra[f"launches_hd{WIDE_ONE_HEAD_HD}"] = (
                one_head_user["launches"].get(key, 0))
        kernels.append(row(
            row_name, "flash_cross.cu", replaces,
            launches if launches is not None
            else at["launches"] + at32["launches"],
            max(at["err"], at32["err"], at1["err"], *(
                [one["b13_hd1536"]["err"]] if key == "b13" else []),
                scalar["errs"].get(key, 0.0)),
            at["ms"], at["plain_ms"],
            at["bound_ms"], at["bound_by"], at["library_ms"], head_dim=512,
            sdpa_backend=wide[b16]["sdpa_backend"],
            **{f"{k}_fp32": at32[k] for k in ("ms", "plain_ms", "bound_ms",
                                              "library_ms")},
            **{f"{k}_{USER_BATCH}users": wide["users"][key][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            **{f"sdpa_backend_{USER_BATCH}users":
               wide["users"]["sdpa_backend"]}, **extra))
    # the fp32 chunked form (the 3xTF32 cluster kernels of
    # flash_chunked_cluster.cuh): hd-512 figures, hd 320's and one head of
    # 1024, 1536 and 2048's as extra keys, with the form each ran; K1 / B7b's
    # dq launches from their entry point's run in (a), B13 / B14 from the
    # float32 2-head user step and evaluation (with B14's device ms a step),
    # B14p from its entry point's run in (a)
    f32, w32 = torch.float32, wide["fp32"]
    for key, row_name, replaces, kernel in (
            ("k1", "flash_causal_fwd_hd512_fp32", "flash_causal_vjp.py:78",
             "chunk_fwd_cl32"),
            ("dq", "flash_causal_bwd_dq_hd512_fp32",
             "flash_causal_vjp.py:158", "chunk_bwd_rows_cl32")):
        at = causal[(512, f32)]
        e = "o" if key == "k1" else "dq"
        kernels.append(row(
            row_name, "flash_chunked_cluster.cuh", replaces,
            at["launches"][("k1", "dq").index(key)],
            max(w32["errs"][e], *(causal[(hd, f32)]["errs"][e]
                                  for hd in WIDE_HDS)),
            **at[key], head_dim=512, sdpa_backend=at["sdpa_backend"],
            kernel=kernel, activations="float32",
            **{f"{k}_hd320": v for k, v in causal[(320, f32)][key].items()
               if k in timed},
            forms={hd: causal[(hd, f32)]["forms"][key] for hd in WIDE_HDS}
            | {hd: f[{"k1": "fwd", "dq": "rows"}[key]]
               for hd, f in w32["forms"].items()}))
    for key, row_name, replaces in (
            ("b13", "flash_cross_attention_hd512_fp32", "attention.py:163"),
            ("b14_fwd", "flash_cross_proj_fwd_hd512_fp32", "flash_vjp.py:362"),
            ("b14_bwd", "flash_cross_proj_bwd_hd512_fp32", "flash_vjp.py:426"),
            ("b14p_fwd", "flash_cross_attention_vjp_fwd_hd512_fp32",
             "flash_vjp.py:51"),
            ("b14p_bwd", "flash_cross_attention_vjp_bwd_hd512_fp32",
             "flash_vjp.py:113")):
        at, at64 = wide[f32][key], wide["users_fp32"][key]
        way = "fwd" if key == "b13" or key.endswith("_fwd") else "rows"
        extra = {f"{k}_hd{hd}": w32["timed"][hd][key][k]
                 for hd in WIDE_FP32_TIMED if key in w32["timed"][hd]
                 for k in (*timed, "bound_by")}
        extra.update({f"{k}_{USER_BATCH}users": at64[k]
                      for k in (*timed, "bound_by")})
        if key.startswith("b14_"):  # device ms a float32 2-head user step
            extra["step_device_ms"] = (wide_user32["ms"]["b14_device_ms"]
                                       or {}).get(key[4:])
        kernels.append(row(
            row_name, "flash_chunked_cluster.cuh", replaces,
            at["launches"] if key.startswith("b14p")
            else wide_user32["launches"][key],
            max(at["err"], at64["err"], w32["errs"][key], *(
                w32["timed"][hd][key]["err"] for hd in WIDE_FP32_TIMED
                if key in w32["timed"][hd])),
            at["ms"], at["plain_ms"], at["bound_ms"], at["bound_by"],
            at["library_ms"], head_dim=512,
            sdpa_backend=wide[f32]["sdpa_backend"], activations="float32",
            kernel="chunk_fwd_cl32" if way == "fwd" else "chunk_bwd_rows_cl32",
            forms={512: "cluster_tf32"} | {hd: f[way] for hd, f in
                                           w32["forms"].items()}, **extra))
    log(f"(c) LM-head decoding tokens/s: {json.dumps(lm['tokens_per_s'])}, "
        f"bf16 agreement {lm['bf16_agreement']:.4f}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
