"""The port imports torch and never JAX or Flax, and builds nothing at import
time; its kernel wrappers take the plain versions for CPU tensors and leave
their launch counters at 0."""

import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import unirec_tpu_torch
names = ["unirec_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(unirec_tpu_torch.__path__,
                                          "unirec_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "triton"))
import json
print(json.dumps({"modules": len(names), "framework": bad}))
"""


def test_fresh_import_loads_no_jax_or_flax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["modules"] >= 15  # every module of the package imported
    assert result["framework"] == []


def test_cpu_wrappers_use_plain_versions():
    from unirec_tpu_torch.ops import _build
    from unirec_tpu_torch.ops import fused_qformer_layer as fq
    from unirec_tpu_torch.ops.flash_causal import flash_causal_attention
    from unirec_tpu_torch.ops.ranking import retrieve_top_k

    blocks = (fq.fused_self_attention_block, fq.fused_cross_attention_block,
              fq.fused_ffn_block)
    for fn in (flash_causal_attention, retrieve_top_k) + blocks:
        fn.launches = 0
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 8, 2 * 128, generator=gen)
    kv = torch.randn(1, 8, 128, generator=gen)
    out = flash_causal_attention(q, kv, kv, torch.ones(1, 8), 2, 1)
    s, i = retrieve_top_k(torch.randn(3, 16, generator=gen),
                          torch.randn(50, 16, generator=gen), k=5)
    assert out.shape == q.shape and s.shape == i.shape == (3, 5)
    # B1-B3 in bfloat16, the dtype their kernels take on the card
    d, k, f, dm, inter = 16, 4, 3, 8, 32

    def w(*shape):
        return torch.randn(*shape, generator=gen).bfloat16()

    def v(n):
        return torch.randn(n, generator=gen)

    x = w(2, k, d)
    y1 = fq.fused_self_attention_block(x, w(3 * d, d), v(3 * d), w(d, d), v(d),
                                       v(d), v(d), num_heads=2, n_q=k)
    y2 = fq.fused_cross_attention_block(
        x, w(2, f, dm), torch.zeros(2, f), w(d, d), v(d), w(2 * d, dm),
        v(2 * d), w(d, d), v(d), v(d), v(d), num_heads=2, n_q=k, n_kv=f)
    y3 = fq.fused_ffn_block(x, w(inter, d), v(inter), w(d, inter), v(d), v(d),
                            v(d))
    assert all(y.shape == x.shape and y.dtype == torch.bfloat16
               for y in (y1, y2, y3))
    for fn in (flash_causal_attention, retrieve_top_k) + blocks:
        assert fn.launches == 0, fn.__name__
    # nothing was compiled or loaded for CPU tensors
    assert _build.load_kernels.cache_info().currsize == 0


def test_cpu_int8_wrappers_use_plain_versions():
    from unirec_tpu_torch.ops import _build
    from unirec_tpu_torch.ops import fused_qformer_int8 as pq
    from unirec_tpu_torch.ops.quantization import (
        quantize_rows,
        retrieve_top_k_int8,
    )

    wrappers = (pq.fused_self_attention_block_q,
                pq.fused_cross_attention_block_q, pq.fused_ffn_block_q,
                retrieve_top_k_int8)
    for fn in wrappers:
        fn.launches = 0
    gen = torch.Generator().manual_seed(0)
    d, k, f, dm, inter = 16, 4, 3, 16, 128

    def q(*shape):  # (int8 weight [out, in], float32 scales [out])
        return pq.quantize_weight(torch.randn(*shape, generator=gen))

    def v(n):
        return torch.randn(n, generator=gen)

    x = torch.randn(2, k, d, generator=gen).bfloat16()
    y1 = pq.fused_self_attention_block_q(x, *q(3 * d, d), v(3 * d), *q(d, d),
                                         v(d), v(d), v(d), num_heads=2, n_q=k)
    y2 = pq.fused_cross_attention_block_q(
        x, torch.randn(2, f, dm, generator=gen).bfloat16(), torch.zeros(2, f),
        *q(d, d), v(d), *q(2 * d, dm), v(2 * d), *q(d, d), v(d), v(d), v(d),
        num_heads=2, n_q=k, n_kv=f)
    y3 = pq.fused_ffn_block_q(x, *q(inter, d), v(inter), *q(d, inter), v(d),
                              v(d), v(d))
    assert all(y.shape == x.shape and y.dtype == torch.bfloat16
               for y in (y1, y2, y3))
    codes, scales = quantize_rows(torch.randn(50, 16, generator=gen))
    s, i = retrieve_top_k_int8(torch.randn(3, 16, generator=gen), codes,
                               scales, k=5)
    assert s.shape == i.shape == (3, 5)
    for fn in wrappers:
        assert fn.launches == 0, fn.__name__
    assert _build.load_kernels.cache_info().currsize == 0


def test_cpu_qwen3_int8_wrappers_use_plain_versions():
    from unirec_tpu_torch.ops import _build
    from unirec_tpu_torch.ops import fused_qwen3_int8 as pf
    from unirec_tpu_torch.ops.fused_qformer_int8 import quantize_weight
    from unirec_tpu_torch.ops.int8_matmul import int8_linear
    from unirec_tpu_torch.ops.int8_ste import int8_linear_ste

    wrappers = (int8_linear, pf.qkv_int8, pf.swiglu_mlp_int8)
    for fn in wrappers:
        fn.launches = 0
    gen = torch.Generator().manual_seed(0)
    d, inter, rows = 128, 256, 512

    def q(*shape):  # (int8 weight [out, in], float32 scales [out])
        return quantize_weight(torch.randn(*shape, generator=gen))

    x = torch.randn(rows, d, generator=gen).bfloat16()
    y8 = int8_linear(x, *q(64, d))
    ys = int8_linear_ste(x[None], *q(64, d))
    yq = pf.qkv_int8(x, *q(3 * d, d))
    ym = pf.swiglu_mlp_int8(x, *q(2 * inter, d), *q(d, inter))
    yf = pf.int8_linear_fused_ste(x, *q(3 * d, d))
    assert y8.shape == (rows, 64) and ys.shape == (1, rows, 64)
    assert yq.shape == yf.shape == (rows, 3 * d) and ym.shape == x.shape
    assert all(y.dtype == torch.bfloat16 for y in (y8, ys, yq, ym, yf))
    for fn in wrappers:
        assert fn.launches == 0, fn.__name__
    assert _build.load_kernels.cache_info().currsize == 0
