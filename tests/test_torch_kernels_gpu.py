"""The port's CUDA kernels against their plain versions on the card, at the
shapes of the serving slice and of the item-token sweep (the comparisons of
chip_smoke.py's kernel phases).

Marked ``gpu``: each test asks the ``hopper`` fixture, which skips unless a
CUDA device of compute capability 9.0 is present.  Run them on the card with
``python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q`` (the
card's machine has no JAX, which ``tests/conftest.py`` imports).

B1-B6 (bf16 in, bf16 out) are held to their plain versions on the same bf16
inputs, compared in fp32: max |diff| <= 5e-2 on the unit-scale LayerNorm
outputs (a few bf16 ulps: the kernel and the plain version sum in different
orders, which can flip a bf16 rounding of qkv, probabilities, ctx or the gelu
output, and in B4-B6 through it one int8 code) and per-row cosine >= 0.9999.
B11 is held as K2: scores within 1e-5, ids equal except near-ties.

B8 and B9a (the Qwen3 W8A8 projections) are held to their plain versions
within one bf16 ulp of each reference value: the integer sums are exact and
both round the epilogue at the same points, so they are expected to be equal.
B9b has per-row cosine >= 0.9999 and max|d| <= 1e-2 max|ref|: the card's
sigmoid is not torch's, which can flip one code of the requantized h.
"""

import pytest
import torch

from unirec_tpu_torch.ops import fused_qformer_int8 as pq
from unirec_tpu_torch.ops import fused_qwen3_int8 as pf
from unirec_tpu_torch.ops import fused_qformer_layer as fq
from unirec_tpu_torch.ops.flash_causal import (
    flash_causal_attention,
    flash_causal_attention_plain,
)
from unirec_tpu_torch.ops.int8_matmul import int8_linear, int8_linear_plain
from unirec_tpu_torch.ops.losses import l2_normalize
from unirec_tpu_torch.ops.quantization import (
    quantize_rows,
    quantized_scores,
    quantized_top_k,
    retrieve_top_k_int8,
)
from unirec_tpu_torch.ops.ranking import retrieve_top_k, top_k_items

pytestmark = pytest.mark.gpu


@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper GPU: no CUDA device")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs an NVIDIA Hopper GPU (compute capability 9.0)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_k1_matches_plain(hopper, dtype, tol):
    b, l, hq, hkv, hd = 8, 512, 16, 8, 128
    q = torch.randn(b, l, hq * hd, device="cuda", generator=hopper).to(dtype)
    k = torch.randn(b, l, hkv * hd, device="cuda", generator=hopper).to(dtype)
    v = torch.randn(b, l, hkv * hd, device="cuda", generator=hopper).to(dtype)
    lengths = torch.tensor([1, 7, 64, 65, 200, 333, 511, 512], device="cuda")
    mask = (torch.arange(l, device="cuda")[None] < lengths[:, None]).float()
    before = flash_causal_attention.launches
    out = flash_causal_attention(q, k, v, mask, hq, hkv)
    torch.cuda.synchronize()
    assert flash_causal_attention.launches == before + 1
    ref = flash_causal_attention_plain(q.float(), k.float(), v.float(), mask,
                                       hq, hkv)
    rel = (out.float() - ref).abs().max() / ref.abs().max()
    assert rel <= tol


@pytest.mark.parametrize("n_users", [8, 64])
def test_k2_matches_plain(hopper, n_users):
    users = torch.randn(n_users, 1024, device="cuda", generator=hopper)
    catalog = torch.randn(20_000, 1024, device="cuda", generator=hopper)
    s, i = retrieve_top_k(users, catalog, k=20)
    torch.cuda.synchronize()
    s_ref, i_ref = top_k_items(users, catalog, k=20)
    assert (s - s_ref).abs().max() <= 1e-5
    full = l2_normalize(users) @ l2_normalize(catalog).T
    diff = i != i_ref  # only near-ties (< 1e-6 apart) may swap
    assert ((full.gather(1, i) - s_ref)[diff].abs() < 1e-6).all()


# -- B1-B3 at the sweep's production widths ----------------------------------

D, HEADS, K, F, INTER = 1024, 16, 32, 14, 4096
BLOCK_ATOL, BLOCK_COS = 5e-2, 0.9999


def _rand(gen, *shape, std=1.0, dtype=torch.bfloat16):
    return (torch.randn(*shape, device="cuda", generator=gen) * std).to(dtype)


def _vec(gen, n, mean=0.0, std=0.1):
    return mean + _rand(gen, n, std=std, dtype=torch.float32)


def _check_block(out, ref):
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    a, b = out.float().reshape(-1, out.shape[-1]), ref.float().reshape(
        -1, ref.shape[-1])
    assert torch.isfinite(a).all()
    assert (a - b).abs().max().item() <= BLOCK_ATOL
    assert torch.nn.functional.cosine_similarity(a, b, dim=-1).min().item() \
        >= BLOCK_COS


def _missing_mask(gen, items):
    mask = (torch.rand(items, F, device="cuda", generator=gen) > 0.15).float()
    mask[:: max(items // 8, 1)][:8] = 0.0  # at least 8 items with no field
    return mask


@pytest.mark.parametrize("items", [1, 1001, 4096])
def test_b1_self_block_matches_plain(hopper, items):
    g = hopper
    x = _rand(g, items, K, D)
    w = dict(wqkv=_rand(g, 3 * D, D, std=0.03), bqkv=_vec(g, 3 * D),
             wo=_rand(g, D, D, std=0.03), bo=_vec(g, D),
             ln_gamma=_vec(g, D, 1.0), ln_beta=_vec(g, D))
    before = fq.fused_self_attention_block.launches
    out = fq.fused_self_attention_block(x, **w, num_heads=HEADS, n_q=K)
    torch.cuda.synchronize()
    assert fq.fused_self_attention_block.launches == before + 1
    _check_block(out, fq.fused_self_attention_block_plain(
        x, **w, num_heads=HEADS, n_q=K))


@pytest.mark.parametrize("items", [1001, 4096])
def test_b2_cross_block_matches_plain(hopper, items):
    g = hopper
    x = _rand(g, items, K, D)
    mask = _missing_mask(g, items)
    mem = _rand(g, items, F, D) * mask[..., None].bfloat16()
    key_bias = ((1.0 - mask) * fq.NEG_INF).contiguous()
    w = dict(wq=_rand(g, D, D, std=0.03), bq=_vec(g, D),
             wkv=_rand(g, 2 * D, D, std=0.03), bkv=_vec(g, 2 * D),
             wo=_rand(g, D, D, std=0.03), bo=_vec(g, D),
             ln_gamma=_vec(g, D, 1.0), ln_beta=_vec(g, D))
    kw = dict(num_heads=HEADS, n_q=K, n_kv=F)
    before = fq.fused_cross_attention_block.launches
    out = fq.fused_cross_attention_block(x, mem, key_bias, **w, **kw)
    torch.cuda.synchronize()
    assert fq.fused_cross_attention_block.launches == before + 1
    _check_block(out, fq.fused_cross_attention_block_plain(
        x, mem, key_bias, **w, **kw))
    # an item with no field does not depend on the rest of the batch
    empty = int(torch.nonzero(mask.sum(1) == 0)[0])
    alone = fq.fused_cross_attention_block(
        x[empty:empty + 1], mem[empty:empty + 1],
        key_bias[empty:empty + 1].contiguous(), **w, **kw)
    assert torch.equal(alone[0], out[empty])


@pytest.mark.parametrize("items", [1001, 4096])
def test_b3_ffn_block_matches_plain(hopper, items):
    g = hopper
    x = _rand(g, items, K, D)
    w = dict(w1=_rand(g, INTER, D, std=0.03), b1=_vec(g, INTER),
             w2=_rand(g, D, INTER, std=0.02), b2=_vec(g, D),
             ln_gamma=_vec(g, D, 1.0), ln_beta=_vec(g, D))
    before = fq.fused_ffn_block.launches
    out = fq.fused_ffn_block(x, **w)
    torch.cuda.synchronize()
    assert fq.fused_ffn_block.launches == before + 1
    _check_block(out, fq.fused_ffn_block_plain(x, **w))


def test_blocks_refuse_fp32_on_the_card(hopper):
    x = torch.zeros(2, K, D, device="cuda")
    w = torch.zeros(3 * D, D, device="cuda")
    v = torch.zeros(3 * D, device="cuda")
    d = torch.zeros(D, device="cuda")
    with pytest.raises(TypeError):
        fq.fused_self_attention_block(x, w, v, w[:D], d, d, d,
                                      num_heads=HEADS, n_q=K)


@pytest.mark.parametrize("n_q", [128, 256])
def test_b1_b2_take_k_up_to_256(hopper, n_q):
    """The repaired attention kernel: K=128 and 256 query rows per item
    (query tiles of 64, keys and values as bf16 in shared memory)."""
    g, items = hopper, 64
    x = _rand(g, items, n_q, D)
    sw = dict(wqkv=_rand(g, 3 * D, D, std=0.03), bqkv=_vec(g, 3 * D),
              wo=_rand(g, D, D, std=0.03), bo=_vec(g, D),
              ln_gamma=_vec(g, D, 1.0), ln_beta=_vec(g, D))
    out = fq.fused_self_attention_block(x, **sw, num_heads=HEADS, n_q=n_q)
    torch.cuda.synchronize()
    _check_block(out, fq.fused_self_attention_block_plain(
        x, **sw, num_heads=HEADS, n_q=n_q))
    mask = _missing_mask(g, items)
    mem = _rand(g, items, F, D) * mask[..., None].bfloat16()
    key_bias = ((1.0 - mask) * fq.NEG_INF).contiguous()
    cw = dict(wq=_rand(g, D, D, std=0.03), bq=_vec(g, D),
              wkv=_rand(g, 2 * D, D, std=0.03), bkv=_vec(g, 2 * D),
              wo=_rand(g, D, D, std=0.03), bo=_vec(g, D),
              ln_gamma=_vec(g, D, 1.0), ln_beta=_vec(g, D))
    kw = dict(num_heads=HEADS, n_q=n_q, n_kv=F)
    out = fq.fused_cross_attention_block(x, mem, key_bias, **cw, **kw)
    torch.cuda.synchronize()
    _check_block(out, fq.fused_cross_attention_block_plain(
        x, mem, key_bias, **cw, **kw))


# -- B4-B6: the W8A8 blocks -----------------------------------------------------


def _q(gen, *shape, std):
    """(int8 [out, in], float32 [out]) from a bf16-rounded random weight."""
    return pq.quantize_weight(_rand(gen, *shape, std=std))


def _int8_weights(g):
    sw = dict(zip(("wqkv", "sqkv"), _q(g, 3 * D, D, std=0.03)))
    sw.update(zip(("wo", "so"), _q(g, D, D, std=0.03)))
    sw.update(bqkv=_vec(g, 3 * D), bo=_vec(g, D), ln_gamma=_vec(g, D, 1.0),
              ln_beta=_vec(g, D))
    cw = dict(zip(("wq", "sq"), _q(g, D, D, std=0.03)))
    cw.update(zip(("wkv", "skv"), _q(g, 2 * D, D, std=0.03)))
    cw.update(zip(("wo", "so"), _q(g, D, D, std=0.03)))
    cw.update(bq=_vec(g, D), bkv=_vec(g, 2 * D), bo=_vec(g, D),
              ln_gamma=_vec(g, D, 1.0), ln_beta=_vec(g, D))
    fw = dict(zip(("w1", "s1"), _q(g, INTER, D, std=0.03)))
    fw.update(zip(("w2", "s2"), _q(g, D, INTER, std=0.02)))
    fw.update(b1=_vec(g, INTER), b2=_vec(g, D), ln_gamma=_vec(g, D, 1.0),
              ln_beta=_vec(g, D))
    return sw, cw, fw


@pytest.mark.parametrize("items", [1001, 4096])
def test_b4_b5_b6_match_plain(hopper, items):
    g = hopper
    x = _rand(g, items, K, D)
    mask = _missing_mask(g, items)
    mem = _rand(g, items, F, D) * mask[..., None].bfloat16()
    key_bias = ((1.0 - mask) * fq.NEG_INF).contiguous()
    sw, cw, fw = _int8_weights(g)
    sk = dict(num_heads=HEADS, n_q=K)
    ck = dict(num_heads=HEADS, n_q=K, n_kv=F)
    runs = [
        (pq.fused_self_attention_block_q, pq.fused_self_attention_block_q_plain,
         (x,), sw, sk),
        (pq.fused_self_attention_block_q, pq.fused_self_attention_block_q_plain,
         (x[:1].contiguous(),), sw, sk),  # layer 0: one item
        (pq.fused_cross_attention_block_q,
         pq.fused_cross_attention_block_q_plain, (x, mem, key_bias), cw, ck),
        (pq.fused_ffn_block_q, pq.fused_ffn_block_q_plain, (x,), fw, {}),
    ]
    for kern, plain, args, w, kw in runs:
        before = kern.launches
        out = kern(*args, **w, **kw)
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        _check_block(out, plain(*args, **w, **kw))
    empty = int(torch.nonzero(mask.sum(1) == 0)[0])
    alone = pq.fused_cross_attention_block_q(
        x[empty:empty + 1], mem[empty:empty + 1],
        key_bias[empty:empty + 1].contiguous(), **cw, **ck)
    full = pq.fused_cross_attention_block_q(x, mem, key_bias, **cw, **ck)
    assert torch.equal(alone[0], full[empty])


@pytest.mark.parametrize("n_users", [8, 64])
def test_b11_matches_plain(hopper, n_users):
    catalog = torch.randn(20_000, 1024, device="cuda", generator=hopper)
    codes, scales = quantize_rows(catalog)
    users = torch.randn(n_users, 1024, device="cuda", generator=hopper)
    before = retrieve_top_k_int8.launches
    s, i = retrieve_top_k_int8(users, codes, scales, k=20)
    torch.cuda.synchronize()
    assert retrieve_top_k_int8.launches == before + 1
    s_ref, i_ref = quantized_top_k(users, codes, scales, k=20)
    assert (s - s_ref).abs().max() <= 1e-5
    full = quantized_scores(users, codes, scales)
    diff = i != i_ref  # only near-ties (< 1e-6 apart) may swap
    assert ((full.gather(1, i) - s_ref)[diff].abs() < 1e-6).all()


# -- B8, B9a, B9b: the int8 Qwen3-0.6B serving forward -----------------------------

QWEN_D, QWEN_I, QWEN_QKV = 1024, 3072, 4096


def _within_one_ulp(out, ref):
    """|out - ref| <= one bf16 ulp of ref, elementwise."""
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    a, b = out.float(), ref.float()
    assert torch.isfinite(a).all()
    ulp = torch.exp2(torch.floor(torch.log2(b.abs().clamp_min(1e-30))) - 7)
    assert ((a - b).abs() <= ulp).all()


@pytest.mark.parametrize("rows,k,n", [(4096, 1024, 2048), (4096, 1024, 1024),
                                      (4096, 2048, 1024), (4096, 1024, 3072),
                                      (4096, 3072, 1024),
                                      (16384, 1024, 2048)])
def test_b8_matches_plain(hopper, rows, k, n):
    g = hopper
    x = _rand(g, rows, k)
    x[7] = 0.0  # a row below the absmax floor
    wq, ws = _q(g, n, k, std=0.03)
    before = int8_linear.launches
    out = int8_linear(x, wq, ws)
    torch.cuda.synchronize()
    assert int8_linear.launches == before + 1
    _within_one_ulp(out, int8_linear_plain(x, wq, ws))
    assert (out[7] == 0).all()


def test_b9a_matches_plain(hopper):
    g = hopper
    x = _rand(g, 4096, QWEN_D)
    wq, ws = _q(g, QWEN_QKV, QWEN_D, std=0.03)
    before = pf.qkv_int8.launches
    out = pf.qkv_int8(x, wq, ws)
    torch.cuda.synchronize()
    assert pf.qkv_int8.launches == before + 1
    _within_one_ulp(out, pf.qkv_int8_plain(x, wq, ws))


@pytest.mark.parametrize("rows", [512, 4096])
def test_b9b_matches_plain(hopper, rows):
    g = hopper
    x = _rand(g, rows, QWEN_D)
    wgu, sgu = _q(g, 2 * QWEN_I, QWEN_D, std=0.03)
    wd, sd = _q(g, QWEN_D, QWEN_I, std=0.02)
    before = pf.swiglu_mlp_int8.launches
    out = pf.swiglu_mlp_int8(x, wgu, sgu, wd, sd)
    torch.cuda.synchronize()
    assert pf.swiglu_mlp_int8.launches == before + 1
    ref = pf.swiglu_mlp_int8_plain(x, wgu, sgu, wd, sd).float()
    assert out.shape == x.shape and out.dtype == torch.bfloat16
    a = out.float()
    assert torch.isfinite(a).all()
    assert (a - ref).abs().max() <= 1e-2 * ref.abs().max()
    assert torch.nn.functional.cosine_similarity(a, ref, dim=-1).min() \
        >= 0.9999


def test_qwen3_int8_wrappers_refuse_what_the_kernels_do_not_take(hopper):
    x = torch.zeros(512, QWEN_D, device="cuda")
    wq = torch.zeros(QWEN_QKV, QWEN_D, dtype=torch.int8, device="cuda")
    ws = torch.ones(QWEN_QKV, device="cuda")
    with pytest.raises(TypeError):  # fp32 activations are not ported
        pf.qkv_int8(x, wq, ws)
    with pytest.raises(TypeError):
        int8_linear(x.bfloat16(), wq, ws, out_dtype=torch.float32)
    with pytest.raises(ValueError):
        int8_linear(x.bfloat16()[:, :1000].contiguous(),
                    wq[:, :1000].contiguous(), ws)
