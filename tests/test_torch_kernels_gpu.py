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
K2 and B11 are held to their plain versions at 1, 8, 24, 64 and 200 users
over 1, 37, 20,000 and 20,001 rows of width 1021 and 1024, k 1, 20 and 32,
with a zero row, equal rows across share boundaries and all scores negative:
scores within 1e-5, ids equal except near-ties, repeats bit for bit, one
counted launch a call.

B8 and B9a (the Qwen3 W8A8 projections) give their plain versions' bits:
the integer sums are exact and both round the epilogue at the same points.
B9b has per-row cosine >= 0.9999 and max|d| <= 1e-2 max|ref|: the card's
sigmoid is not torch's, which can flip one code of the requantized h; its
codes of h and its down product are held bit for bit to the plain forms
over its own h.

B7b (the flash backward) and K1's training form are held to their plain
versions at the joint training shape: max|d| <= 1e-5 max|ref| in fp32 and
2e-2 in bf16, per-row cosine >= 0.9999; the autograd Function's gradients
equal the two kernels' outputs, and padded keys get no gradient.  K1 and
B7b run at every head dim the model configs use (16, 32, 64, 128), at hd 8
and 24 (zero-padded to 16 and 32) and 256, over key tiles that are all
padding, and repeat bit for bit; B7b's float32 dq and dk / dv (3xTF32 on
tensor cores) at every instance up to 256 and at 8 and 24, GQA 2:1, 3:1 and
MHA, held at 1e-5 and row cosine 0.9999.  B13 / B14 / B14p run at hd 8,
24, 64, 128 and 256 in bf16 (the tensor-core forward and one-pass backward)
and at every instance up to 256 and 8 and 24 in float32 (3xTF32 on tensor
cores) at Lq 64, 1 and 200 over a ragged last key tile; B15 at hd 8 and 24 and at every head
dim and F (C-8).  K1-B14p run head dims above 256 in their chunked form
(320 and 512: two chunks of 256; 768: three, in bf16 K1, B14's forward and
B7b's dk / dv on tensor cores, dq and B14's backward in the cluster form;
the bf16 forms' bounds at 768-2304, the cluster form at 6-8 chunks forward
and 3-8 over rows, 9 chunks scalar; float32 K1, B7b's dq, B13, B14 and
B14p at every chunk count 2-8 in the 3xTF32 cluster form at 1e-5, 9
chunks scalar);
B7b's dk / dv on tensor cores at 320, 512 and 768; a head dim of 0 is
refused, naming the set.  The int8 GEMM of B4-B6 and B8-B9b is held bit for bit to its plain
form in every epilogue; B1-B6 run
at hidden 1020 and 1032 (C-10).  B1-B3 run on each route of their
LayerNorm (the cluster epilogue at hidden 1024 and at 896, whose last tile
is ragged; two passes at 2304 and 1020) and repeat bit for bit; the
cluster epilogue alone is held to the two-pass route within a bf16 ulp.
The fp32 forms: B1-B3 and B12s/B12c (forward, backward and through
autograd) at float32 within 1e-5 of max|ref|, B4-B6 at float32 activations
within the int8 blocks' gate, B6's codes of x those of its float32 values
bit for bit.
"""

import pytest
import torch

import chip_smoke
from unirec_tpu_torch.ops import fused_qformer_int8 as pq
from unirec_tpu_torch.ops import fused_qwen3_int8 as pf
from unirec_tpu_torch.ops import fused_qformer_layer as fq
from unirec_tpu_torch.ops import flash_causal as fc
from unirec_tpu_torch.ops.flash_causal import (
    flash_causal_attention,
    flash_causal_attention_plain,
)
from unirec_tpu_torch.ops.int8_matmul import (
    int8_linear,
    int8_linear_plain,
    kernel_row_quant,
)
from unirec_tpu_torch.ops.quantization import quantize_rows

pytestmark = pytest.mark.gpu


@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper GPU: no CUDA device")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs an NVIDIA Hopper GPU (compute capability 9.0)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


CAUSAL_HEAD_DIMS = (16, 32, 64, 128, 8, 24, 256, 320, 512, 300)


@pytest.mark.parametrize("hd", CAUSAL_HEAD_DIMS)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_k1_matches_plain(hopper, dtype, tol, hd):
    b, l, hq, hkv = 8, 512, 16, 8
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
    assert torch.equal(out, flash_causal_attention(q, k, v, mask, hq, hkv))


def _single_key_rows(mask, heads):
    """Rows whose causal window holds one valid key, per (batch, row, head):
    their exact dq is 0 (a softmax over one key has no gradient), so both
    sides are rounding noise along k_0 and the row cosine is its sign;
    max|d| still holds them."""
    one = mask.cumsum(1) == 1
    return one[:, :, None].expand(-1, -1, heads).reshape(-1)


def _lone_key_rows(mask, heads):
    """dk's rows of exact value 0, per (batch, key, KV head): key 0 of a
    batch row whose only valid key it is (every query attends it alone)."""
    lone = torch.zeros_like(mask, dtype=torch.bool)
    lone[:, 0] = mask.sum(1) == 1
    return lone[:, :, None].expand(-1, -1, heads).reshape(-1)


def _close(out, ref, tol, hd=128, noise_rows=None):
    a, b = out.float(), ref.float()
    assert torch.isfinite(a).all()
    assert (a - b).abs().max() / b.abs().max() <= tol
    if a.dim() == 3 and a.shape[-1] % hd == 0:
        a2, b2 = a.reshape(-1, hd), b.reshape(-1, hd)
        live = b2.abs().amax(-1) > 0
        if noise_rows is not None:
            live &= ~noise_rows
        cos = torch.nn.functional.cosine_similarity(a2[live], b2[live], dim=-1)
        assert cos.min() >= 0.9999


@pytest.mark.parametrize("hd", CAUSAL_HEAD_DIMS)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_b7b_and_k1_stats_match_plain(hopper, dtype, tol, hd):
    b, l, hq, hkv = 8, 512, 16, 8
    q, k, v, do = (torch.randn(b, l, h * hd, device="cuda", generator=hopper)
                   .to(dtype) for h in (hq, hkv, hkv, hq))
    lengths = torch.tensor([1, 5, 64, 100, 257, 400, 511, 512], device="cuda")
    mask = (torch.arange(l, device="cuda")[None] < lengths[:, None]).float()
    before = [fn.launches for fn in (flash_causal_attention,
                                     fc.flash_causal_bwd_dq,
                                     fc.flash_causal_bwd_dkv)]
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    out = fc.flash_causal_attention_train(qs, ks, vs, mask, hq, hkv)
    out.backward(do)
    torch.cuda.synchronize()
    assert [fn.launches for fn in (flash_causal_attention,
                                   fc.flash_causal_bwd_dq,
                                   fc.flash_causal_bwd_dkv)] == [
        n + 1 for n in before]
    o, m, den = fc.flash_causal_attention_fwd_plain(
        q.float(), k.float(), v.float(), mask, hq, hkv)
    _close(out, o, tol, hd)
    _, m_k, l_k = fc._k1(q, k, v, mask, hq, hkv, stats=True)
    _close(m_k, m, tol, hd)
    _close(l_k, den, tol, hd)
    dsum = fc.attention_dsum(do, out.detach(), hq)
    want = fc.flash_causal_attention_bwd_plain(
        q.float(), k.float(), v.float(), mask, do.float(), m_k, l_k, dsum,
        hq, hkv)
    _close(qs.grad, want[0], tol, hd, _single_key_rows(mask, hq))
    _close(ks.grad, want[1], tol, hd, _lone_key_rows(mask, hkv))
    _close(vs.grad, want[2], tol, hd)
    padded = mask == 0
    assert (ks.grad[padded] == 0).all() and (vs.grad[padded] == 0).all()
    args = (q, k, v, mask, do.contiguous(), m_k, l_k, dsum.contiguous(), hq,
            hkv)
    dq = fc.flash_causal_bwd_dq(*args)  # deterministic: no atomics
    assert torch.equal(dq, fc.flash_causal_bwd_dq(*args))
    dk, dv = fc.flash_causal_bwd_dkv(*args)
    dk2, dv2 = fc.flash_causal_bwd_dkv(*args)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_k1_b7b_over_key_tiles_that_are_all_padding(hopper, dtype, tol):
    """Key tiles whose keys are all padding (skipped by the bf16 kernels:
    in the middle of a row, at its end, every tile past key 0's) change
    nothing: output and gradients as the plain versions, padded keys' dk
    and dv exactly 0."""
    b, l, hq, hkv, hd = 3, 512, 8, 4, 64
    mask = torch.ones(b, l, device="cuda")
    mask[0, 64:256] = 0.0  # tiles 1-3 padding, keys after them valid
    mask[1, 320:] = 0.0    # the last three tiles padding
    mask[2, 1:] = 0.0      # key 0 alone
    q, k, v, do = (torch.randn(b, l, h * hd, device="cuda", generator=hopper)
                   .to(dtype) for h in (hq, hkv, hkv, hq))
    o, m, den = fc._k1(q, k, v, mask, hq, hkv, stats=True)
    ref = fc.flash_causal_attention_fwd_plain(q.float(), k.float(), v.float(),
                                              mask, hq, hkv)
    for got, want in zip((o, m, den), ref):
        _close(got, want, tol, hd)
    dsum = fc.attention_dsum(do, o, hq).contiguous()
    args = (q, k, v, mask, do, m, den, dsum, hq, hkv)
    dq = fc.flash_causal_bwd_dq(*args)
    dk, dv = fc.flash_causal_bwd_dkv(*args)
    torch.cuda.synchronize()
    want = fc.flash_causal_attention_bwd_plain(
        q.float(), k.float(), v.float(), mask, do.float(), m, den, dsum, hq,
        hkv)
    _close(dq, want[0], tol, hd, _single_key_rows(mask, hq))
    _close(dk, want[1], tol, hd, _lone_key_rows(mask, hkv))
    _close(dv, want[2], tol, hd)
    padded = mask == 0
    assert (dk[padded] == 0).all() and (dv[padded] == 0).all()


@pytest.mark.parametrize("hd", [0])
def test_flash_causal_wrappers_refuse_what_the_kernels_do_not_take(hopper,
                                                                   hd):
    q = torch.randn(1, 8, 2 * hd, device="cuda", requires_grad=True)
    kv = torch.randn(1, 8, hd, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        fc.flash_causal_attention_train(q, kv, kv, None, 2, 1)
    with pytest.raises(ValueError, match="head_dim"):
        flash_causal_attention(q.detach(), kv, kv, None, 2, 1)
    with pytest.raises(RuntimeError, match="flash_causal_attention_train"):
        flash_causal_attention(q, kv, kv, None, 2, 1)


# K2 and B11 over the partition's edges: users (one, one group of 8, 24, 64,
# two groups), rows (one, fewer than SMs, the serving catalog, a share one
# row short), widths 1021 (C-13) and 1024, k in {1, 20, 32} up to the rows
RETRIEVAL_CASES = [(b, n, d, k) for b in (1, 8, 24, 64, 200)
                   for n in (1, 37, 20_000, 20_001) for d in (1021, 1024)
                   for k in (1, 20, 32) if k <= n]


def _retrieval_inputs(gen, b, n, d, negative):
    """Users and a catalog with a zero row and equal rows across every share
    boundary, user 0 equal to the first boundary's row; ``negative``: every
    other score below 0."""
    base = torch.randn(d, device="cuda", generator=gen) if negative else None
    catalog, plan = chip_smoke.edge_catalog(gen, n, d, base)
    users = torch.randn(b, d, device="cuda", generator=gen)
    if negative:
        users = base + 0.3 * users
    users[0] = 2.0 * catalog[min(plan.rows_per_share, n - 1)]
    return users, catalog


@pytest.mark.parametrize("negative", [False, True])
@pytest.mark.parametrize("n_users,rows,width,k", RETRIEVAL_CASES)
def test_k2_matches_plain(hopper, n_users, rows, width, k, negative):
    """K2 against top_k_items: scores within 1e-5, ids equal but near-ties
    (< 1e-6 apart), ties to the lower index, one counted launch a call,
    identical bits on a repeat (chip_smoke.retrieval_check)."""
    users, catalog = _retrieval_inputs(hopper, n_users, rows, width,
                                       negative)
    chip_smoke.retrieval_check("K2", users, catalog, k)


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


def _block_weights(g, d, inter=INTER):
    return (dict(wqkv=_rand(g, 3 * d, d, std=0.03), bqkv=_vec(g, 3 * d),
                 wo=_rand(g, d, d, std=0.03), bo=_vec(g, d),
                 ln_gamma=_vec(g, d, 1.0), ln_beta=_vec(g, d)),
            dict(wq=_rand(g, d, d, std=0.03), bq=_vec(g, d),
                 wkv=_rand(g, 2 * d, d, std=0.03), bkv=_vec(g, 2 * d),
                 wo=_rand(g, d, d, std=0.03), bo=_vec(g, d),
                 ln_gamma=_vec(g, d, 1.0), ln_beta=_vec(g, d)),
            dict(w1=_rand(g, inter, d, std=0.03), b1=_vec(g, inter),
                 w2=_rand(g, d, inter, std=0.02), b2=_vec(g, d),
                 ln_gamma=_vec(g, d, 1.0), ln_beta=_vec(g, d)))


@pytest.mark.parametrize("d,heads,items,two_pass", [
    (1024, 16, 4096, False), (896, 14, 4096, False), (2304, 18, 4096, True),
    (1024, 16, 1, False)], ids=["cluster", "ragged-cluster", "two-pass",
                                 "32-rows"])
def test_b1_b2_b3_on_each_layer_norm_route(hopper, d, heads, items,
                                           two_pass):
    """B1-B3 against their plain versions on each route of the residual
    product's LayerNorm: the cluster epilogue (hidden 1024: 4 CTAs; 896:
    the last of 4 CTAs 128 columns wide; one item of 32 rows, below one
    128-row tile) and two passes (2304: more than a portable cluster of 8
    CTAs); each call repeated for identical bits."""
    assert fq.two_pass_layer_norm(d, d) is two_pass
    assert fq.two_pass_layer_norm(d, INTER) is two_pass
    g = hopper
    x = _rand(g, items, K, d)
    mask = _missing_mask(g, items)
    mem = _rand(g, items, F, d) * mask[..., None].bfloat16()
    key_bias = ((1.0 - mask) * fq.NEG_INF).contiguous()
    sw, cw, fw = _block_weights(g, d)
    sk = dict(num_heads=heads, n_q=K)
    ck = dict(sk, n_kv=F)
    for fn, args, w, kw in (
            ("fused_self_attention_block", (x,), sw, sk),
            ("fused_cross_attention_block", (x, mem, key_bias), cw, ck),
            ("fused_ffn_block", (x,), fw, {})):
        kern = getattr(fq, fn)
        before = kern.launches
        out = kern(*args, **w, **kw)
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        _check_block(out, getattr(fq, fn + "_plain")(*args, **w, **kw))
        assert torch.equal(out, kern(*args, **w, **kw))


def test_two_pass_layer_norm_routes_by_shape(hopper):
    """The kernels' route for a residual product (unirec_resid_ln_two_pass,
    csrc/gemm_wide.cuh wl_shape), which the wrappers ask to size their
    scratch: the cluster epilogue where TMA takes the product's rows (a
    multiple of 8 inputs) and the residual's (a width that is a multiple of
    8), and the width is at most 8 x 256."""
    assert not fq.two_pass_layer_norm(1024, 1024)
    assert not fq.two_pass_layer_norm(1024, 4096)
    assert not fq.two_pass_layer_norm(2048, 1024)
    assert not fq.two_pass_layer_norm(1032, 1032)
    assert fq.two_pass_layer_norm(2056, 1024)
    assert fq.two_pass_layer_norm(1020, 1020)
    assert fq.two_pass_layer_norm(1024, 1020)
    assert fq.two_pass_layer_norm(1020, 4096)


def _within_bf16_rounding(out, ref, atol=1e-5):
    """|out - ref| <= one bf16 ulp of ref + atol, elementwise: two fp32
    values a few fp32 ulps apart, each rounded to bf16 (atol covers the
    outputs near 0, where an fp32 ulp of the unnormalised row is many bf16
    ulps of the output)."""
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    a, b = out.float(), ref.float()
    assert torch.isfinite(a).all()
    ulp = torch.exp2(torch.floor(torch.log2(b.abs().clamp_min(1e-30))) - 7)
    assert ((a - b).abs() <= ulp + atol).all()


@pytest.mark.parametrize("m,n,k", [(32 * 4096, D, D), (32 * 4096, D, INTER),
                                   (32 * 1001, 896, D), (32, D, D),
                                   (4000, 1032, 1032), (4000, 2048, 512)])
def test_cluster_layer_norm_matches_two_passes(hopper, m, n, k):
    """WG_BIAS_RESID_LN (one cluster launch: LayerNorm(a . w^T + bias +
    resid) -> bf16) against WG_BIAS_RESID followed by layer_norm_kernel,
    through the test entry unirec_gemm_ln_test: the same fp32 sums up to the
    LayerNorm's order of summation, so within bf16 rounding; a repeat gives
    the same bits.  Above 2048 columns the cluster launch is refused."""
    from unirec_tpu_torch.ops._build import load_kernels

    g = hopper
    a, w = _rand(g, m, k), _rand(g, n, k, std=k ** -0.5)
    bias, resid = _vec(g, n), _rand(g, m, n)
    gamma, beta = _vec(g, n, 1.0), _vec(g, n)
    acc = torch.empty(m, n, device="cuda")
    outs = [torch.empty(m, n, device="cuda", dtype=torch.bfloat16)
            for _ in range(3)]
    lib = load_kernels().lib
    stream = torch.cuda.current_stream().cuda_stream
    for which, out in zip((0, 1, 1), outs):
        assert lib.unirec_gemm_ln_test(
            which, a.data_ptr(), w.data_ptr(), bias.data_ptr(),
            resid.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            out.data_ptr(), acc.data_ptr() if which == 0 else None, m, n, k,
            1e-12, stream) == 0
    torch.cuda.synchronize()
    _within_bf16_rounding(outs[1], outs[0])
    assert torch.equal(outs[1], outs[2])
    wide = torch.empty(8, 2304, device="cuda", dtype=torch.bfloat16)
    assert lib.unirec_gemm_ln_test(
        1, a.data_ptr(), w.data_ptr(), bias.data_ptr(), resid.data_ptr(),
        gamma.data_ptr(), beta.data_ptr(), wide.data_ptr(), None, 8, 2304,
        k, 1e-12, stream) != 0


def test_blocks_refuse_fp32_on_the_card(hopper):
    """Since the fp32 forms, float32 is taken and other dtypes (fp16) and
    weights of another dtype than x are refused."""
    x = torch.zeros(2, K, D, device="cuda")
    w = torch.zeros(3 * D, D, device="cuda")
    v = torch.zeros(3 * D, device="cuda")
    d = torch.zeros(D, device="cuda")
    out = fq.fused_self_attention_block(x, w, v, w[:D], d, d, d,
                                        num_heads=HEADS, n_q=K)
    assert out.dtype == torch.float32
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fq.fused_self_attention_block(x.half(), w.half(), v, w[:D].half(), d,
                                      d, d, num_heads=HEADS, n_q=K)
    with pytest.raises(TypeError, match="wqkv"):
        fq.fused_self_attention_block(x, w.bfloat16(), v, w[:D], d, d, d,
                                      num_heads=HEADS, n_q=K)


@pytest.mark.parametrize("n_q", [128, 256])
def test_b1_b2_take_k_up_to_256(hopper, n_q):
    """K=128 and 256 query rows per item: tiles of 64 query rows of one
    item in the attention core."""
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


@pytest.mark.parametrize("heads,f", [(4, F), (HEADS, 300)],
                         ids=["hd256", "f300"])
def test_b1_b2_take_wide_heads_and_fields(hopper, heads, f):
    """B1 and B2 at a head dim above 128 (C-6: 4 heads of 256) and B2 at 300
    fields per item (C-9), through the attention core."""
    g, items = hopper, 64
    x = _rand(g, items, K, D)
    sw = dict(wqkv=_rand(g, 3 * D, D, std=0.03), bqkv=_vec(g, 3 * D),
              wo=_rand(g, D, D, std=0.03), bo=_vec(g, D),
              ln_gamma=_vec(g, D, 1.0), ln_beta=_vec(g, D))
    out = fq.fused_self_attention_block(x, **sw, num_heads=heads, n_q=K)
    torch.cuda.synchronize()
    _check_block(out, fq.fused_self_attention_block_plain(
        x, **sw, num_heads=heads, n_q=K))
    mask = (torch.rand(items, f, device="cuda", generator=g) > 0.15).float()
    mask[::8] = 0.0
    mem = _rand(g, items, f, D) * mask[..., None].bfloat16()
    key_bias = ((1.0 - mask) * fq.NEG_INF).contiguous()
    cw = dict(wq=_rand(g, D, D, std=0.03), bq=_vec(g, D),
              wkv=_rand(g, 2 * D, D, std=0.03), bkv=_vec(g, 2 * D),
              wo=_rand(g, D, D, std=0.03), bo=_vec(g, D),
              ln_gamma=_vec(g, D, 1.0), ln_beta=_vec(g, D))
    kw = dict(num_heads=heads, n_q=K, n_kv=f)
    out = fq.fused_cross_attention_block(x, mem, key_bias, **cw, **kw)
    torch.cuda.synchronize()
    _check_block(out, fq.fused_cross_attention_block_plain(
        x, mem, key_bias, **cw, **kw))
    assert torch.equal(out, fq.fused_cross_attention_block(
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
        assert torch.equal(out, kern(*args, **w, **kw))
    empty = int(torch.nonzero(mask.sum(1) == 0)[0])
    alone = pq.fused_cross_attention_block_q(
        x[empty:empty + 1], mem[empty:empty + 1],
        key_bias[empty:empty + 1].contiguous(), **cw, **ck)
    full = pq.fused_cross_attention_block_q(x, mem, key_bias, **cw, **ck)
    assert torch.equal(alone[0], full[empty])


@pytest.mark.parametrize("negative", [False, True])
@pytest.mark.parametrize("n_users,rows,width,k", RETRIEVAL_CASES)
def test_b11_matches_plain(hopper, n_users, rows, width, k, negative):
    """B11 against quantized_top_k, held as K2."""
    users, catalog = _retrieval_inputs(hopper, n_users, rows, width,
                                       negative)
    codes, scales = quantize_rows(catalog)
    chip_smoke.retrieval_check("B11", users, codes, k, scales)


# -- B8, B9a, B9b: the int8 Qwen3-0.6B serving forward -----------------------------

QWEN_D, QWEN_I, QWEN_QKV = 1024, 3072, 4096


@pytest.mark.parametrize("rows,k,n", [(4096, 1024, 2048), (4096, 1024, 1024),
                                      (4096, 2048, 1024), (4096, 1024, 3072),
                                      (4096, 3072, 1024),
                                      (16384, 1024, 2048),
                                      (1000, 1024, 2048)])
def test_b8_matches_plain(hopper, rows, k, n):
    """B8 gives its plain version's bits (the int32 sums are exact in any
    order, the epilogue rounds at the plain version's points), at the
    serving projections and a ragged row count, and repeats them."""
    g = hopper
    x = _rand(g, rows, k)
    x[7] = 0.0  # a row below the absmax floor
    wq, ws = _q(g, n, k, std=0.03)
    before = int8_linear.launches
    out = int8_linear(x, wq, ws)
    torch.cuda.synchronize()
    assert int8_linear.launches == before + 1
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, int8_linear_plain(x, wq, ws))
    assert torch.equal(out, int8_linear(x, wq, ws))
    assert (out[7] == 0).all()


@pytest.mark.parametrize("rows,k,n", [(768, 64, 64), (768, 64, 32),
                                      (768, 128, 64), (4096, 1024, 2048),
                                      (1000, 1024, 2048)])
def test_b8_fp32_matches_plain(hopper, rows, k, n):
    """B8's fp32 form (float32 activations quantized from their float32
    values, float32 out) gives its plain version's bits, at the int8-base
    convergence model's projections (batch 8 x L 96) and at the serving
    shape, repeats them, and is what ``int8_linear_ste`` runs forward on a
    float32 CUDA tensor."""
    from unirec_tpu_torch.ops.int8_ste import int8_linear_ste

    g = hopper
    x = torch.randn(rows, k, device="cuda", generator=g)
    x[7] = 0.0  # a row below the absmax floor
    wq, ws = _q(g, n, k, std=0.03)
    before = int8_linear.launches
    out = int8_linear(x, wq, ws, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert int8_linear.launches == before + 1
    assert out.dtype == torch.float32
    assert torch.equal(out, int8_linear_plain(x, wq, ws, torch.float32))
    assert torch.equal(out, int8_linear(x, wq, ws, out_dtype=torch.float32))
    assert (out[7] == 0).all()
    assert torch.equal(int8_linear_ste(x[None], wq, ws)[0], out)
    assert int8_linear.launches == before + 3


@pytest.mark.parametrize("rows", [4096, 1024])
def test_b9a_matches_plain(hopper, rows):
    g = hopper
    x = _rand(g, rows, QWEN_D)
    wq, ws = _q(g, QWEN_QKV, QWEN_D, std=0.03)
    before = pf.qkv_int8.launches
    out = pf.qkv_int8(x, wq, ws)
    torch.cuda.synchronize()
    assert pf.qkv_int8.launches == before + 1
    assert torch.equal(out, pf.qkv_int8_plain(x, wq, ws))
    assert torch.equal(out, pf.qkv_int8(x, wq, ws))


def _swiglu_entry(x, wgu, sgu, wd, sd):
    """B9b's C entry on scratch the test owns (any row count): (out, h, h's
    codes, h's row scales)."""
    from unirec_tpu_torch.ops._build import check, load_kernels

    rows, d = x.shape
    inter = wd.shape[1]
    out = torch.empty_like(x)
    xq = torch.empty(rows, d, device="cuda", dtype=torch.int8)
    xs, hs = (torch.empty(rows, device="cuda") for _ in range(2))
    h = torch.empty(rows, inter, device="cuda")
    hq = torch.empty(rows, inter, device="cuda", dtype=torch.int8)
    check(load_kernels().lib.unirec_qwen3_swiglu_q(
        x.data_ptr(), wgu.data_ptr(), sgu.data_ptr(), wd.data_ptr(),
        sd.data_ptr(), out.data_ptr(), xq.data_ptr(), xs.data_ptr(),
        h.data_ptr(), hq.data_ptr(), hs.data_ptr(), rows, d, inter,
        torch.cuda.current_stream().cuda_stream), "unirec_qwen3_swiglu_q")
    return out, h, hq, hs


@pytest.mark.parametrize("rows", [512, 4096, 1000])
def test_b9b_matches_plain(hopper, rows):
    """B9b against its plain version (the card's sigmoid is not torch's,
    which can flip a code of h), through the wrapper at whole 512-row tiles
    and through its C entry at a ragged row count; its codes and row scales
    of h are kernel_row_quant's of its own h and its output the down
    product of those codes, bit for bit; a repeat gives the same bits."""
    g = hopper
    x = _rand(g, rows, QWEN_D)
    wgu, sgu = _q(g, 2 * QWEN_I, QWEN_D, std=0.03)
    wd, sd = _q(g, QWEN_D, QWEN_I, std=0.02)
    if rows % 512 == 0:
        before = pf.swiglu_mlp_int8.launches
        out = pf.swiglu_mlp_int8(x, wgu, sgu, wd, sd)
        torch.cuda.synchronize()
        assert pf.swiglu_mlp_int8.launches == before + 1
    got = _swiglu_entry(x, wgu, sgu, wd, sd)
    again = _swiglu_entry(x, wgu, sgu, wd, sd)
    torch.cuda.synchronize()
    if rows % 512 == 0:
        assert torch.equal(out, got[0])
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    out, h, hq, hs = got
    codes, scales = kernel_row_quant(h)
    assert torch.equal(hq, codes) and torch.equal(hs, scales[:, 0])
    assert torch.equal(out, pq._mm_q(hq, hs[:, None], wd, sd).bfloat16())
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


# -- B12s / B12c: the trainable fused Q-Former blocks -----------------------------


TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _check_kernel(name, out, ref, tol=None, min_cos=0.9999, noise_rows=None):
    """max|d| <= tol * max|ref| (by default 1e-5 in float32 and 2e-2 in
    bf16, both sides in the same dtype: the kernel sums in another order,
    which can flip one bf16 rounding of qkv, p, ctx or ds) and, in bf16, the
    per-row cosine >= min_cos over rows where ref is nonzero, except
    ``noise_rows``: the query rows of an item with no valid field, whose
    exact B12c dq is 0 (its keys are all the same row, bkv, and the softmax
    VJP's ds sums to 0 over them), so both versions return rounding noise
    there, which the max|d| bound holds."""
    a, b = out.float(), ref.float()
    assert bool(torch.isfinite(a).all()), name
    rel = ((a - b).abs().max() / b.abs().max()).item()
    assert rel <= (tol or TOL[out.dtype]), (name, rel)
    if out.dtype == torch.bfloat16:
        a2, b2 = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
        live = b2.abs().amax(-1) > 0
        if noise_rows is not None:
            live &= ~noise_rows
        cos = torch.nn.functional.cosine_similarity(a2[live], b2[live], dim=-1)
        assert cos.min().item() >= min_cos, (name, cos.min().item())


def _b12_inputs(gen, items, k=32, f=14, d=1024):
    x = _rand(gen, items * k, d)
    mask = _missing_mask(gen, items)[:, :f]
    mem = (_rand(gen, items, f, d) * mask[..., None].bfloat16()).reshape(-1, d)
    kb = ((1.0 - mask) * -1e9).reshape(-1).contiguous()
    w = {n: _rand(gen, *s, std=0.03) for n, s in (
        ("wqkv", (3 * d, d)), ("wq", (d, d)), ("wkv", (2 * d, d)),
        ("wo", (d, d)))}
    b = {n: _rand(gen, s, std=0.1) for n, s in (("bqkv", 3 * d), ("bq", d),
                                                 ("bkv", 2 * d), ("bo", d))}
    dout = _rand(gen, items * k, d, std=0.1)
    empty = (mask.sum(1) == 0).repeat_interleave(k)  # query rows, no field
    return x, mem, kb, w, b, dout, empty


@pytest.mark.parametrize("items", [509, 512])
def test_b12s_matches_plain_and_repeats_bit_for_bit(hopper, items):
    from unirec_tpu_torch.ops import fused_qformer_vjp as fv

    x, _, _, w, b, dout, _ = _b12_inputs(hopper, items)
    kb = torch.zeros(x.shape[0], device="cuda")
    kw = dict(num_heads=16, n_q=32)
    args = (x, kb, w["wqkv"], b["bqkv"], w["wo"], b["bo"])
    got = fv.self_attention_fwd(*args, **kw)
    torch.cuda.synchronize()
    for name, g, r in zip(("out", "qkv", "ctx"), got,
                          fv.self_attention_fwd_plain(*args, **kw)):
        _check_kernel(name, g, r)
    dqkv = fv.self_attention_bwd(got[1], w["wo"], kb, dout, **kw)
    torch.cuda.synchronize()
    _check_kernel("dqkv", dqkv, fv.self_attention_bwd_plain(
        got[1], w["wo"], kb, dout, **kw))
    again = fv.self_attention_fwd(*args, **kw)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    assert torch.equal(dqkv, fv.self_attention_bwd(got[1], w["wo"], kb, dout,
                                                   **kw))


@pytest.mark.parametrize("items", [509, 512])
def test_b12c_matches_plain_and_repeats_bit_for_bit(hopper, items):
    from unirec_tpu_torch.ops import fused_qformer_vjp as fv

    x, mem, kb, w, b, dout, empty = _b12_inputs(hopper, items)
    kw = dict(num_heads=16, n_q=32, n_kv=14)
    args = (x, mem, kb, w["wq"], b["bq"], w["wkv"], b["bkv"], w["wo"],
            b["bo"])
    got = fv.cross_attention_fwd(*args, **kw)
    torch.cuda.synchronize()
    for name, g, r in zip(("out", "q", "kv", "ctx"), got,
                          fv.cross_attention_fwd_plain(*args, **kw)):
        _check_kernel(name, g, r)
    q, kv = got[1], got[2]
    dq, dkv = fv.cross_attention_bwd(q, kv, w["wo"], kb, dout, **kw)
    torch.cuda.synchronize()
    rq, rkv = fv.cross_attention_bwd_plain(q, kv, w["wo"], kb, dout, **kw)
    _check_kernel("dq", dq, rq, noise_rows=empty)
    _check_kernel("dkv", dkv, rkv)
    again = fv.cross_attention_bwd(q, kv, w["wo"], kb, dout, **kw)
    assert torch.equal(dq, again[0]) and torch.equal(dkv, again[1])
    assert all(torch.equal(a, c) for a, c in
               zip(got, fv.cross_attention_fwd(*args, **kw)))


def test_b12_autograd_gradients_match_plain(hopper):
    """The differentiable blocks on the card against the same Functions on
    the plain versions (the CPU path), every input's gradient."""
    from unirec_tpu_torch.ops import fused_qformer_vjp as fv

    x, mem, kb, w, b, dout, empty = _b12_inputs(hopper, 64)
    d = x.shape[1]
    leaves = [t.clone().requires_grad_() for t in (
        x.reshape(64, 32, d), mem.reshape(64, 14, d), w["wq"], b["bq"],
        w["wkv"], b["bkv"], w["wo"], b["bo"])]
    out = fv.fused_cross_attention_train(leaves[0], leaves[1],
                                         kb.reshape(64, 14), *leaves[2:],
                                         num_heads=16)
    out.backward(dout.reshape(out.shape))
    cpu = [t.detach().cpu().requires_grad_() for t in leaves]
    ref = fv.fused_cross_attention_train(cpu[0], cpu[1],
                                         kb.reshape(64, 14).cpu(), *cpu[2:],
                                         num_heads=16)
    ref.backward(dout.reshape(out.shape).cpu())
    _check_kernel("out", out.detach(), ref.detach().cuda())
    for i, (g, r) in enumerate(zip(leaves, cpu)):
        _check_kernel(f"grad {i}", g.grad, r.grad.cuda(), tol=3e-2,
                      min_cos=0.999, noise_rows=empty if i == 0 else None)


def test_b12_wrappers_refuse_what_the_kernels_do_not_take(hopper):
    """fp16, and activations and weights of two dtypes, are refused; K = 256
    (an item the old kernels' shared memory could not hold) is taken since the attention core (C-7); an item
    of more query tiles than a grid dimension holds is refused by the C
    entry itself (cudaErrorInvalidValue through check)."""
    from unirec_tpu_torch.ops import fused_qformer_vjp as fv

    x, _, _, w, b, _, _ = _b12_inputs(hopper, 2)
    kb = torch.zeros(x.shape[0], device="cuda")
    with pytest.raises(TypeError, match="bfloat16"):
        fv.self_attention_fwd(x.float(), kb, w["wqkv"], b["bqkv"], w["wo"],
                              b["bo"], num_heads=16, n_q=32)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fv.self_attention_fwd(x.half(), kb, w["wqkv"].half(), b["bqkv"],
                              w["wo"].half(), b["bo"], num_heads=16, n_q=32)
    big = _rand(hopper, 256 * 4, 1024)
    args = (big, torch.zeros(1024, device="cuda"), w["wqkv"], b["bqkv"],
            w["wo"], b["bo"])
    got = fv.self_attention_fwd(*args, num_heads=16, n_q=256)
    torch.cuda.synchronize()
    for name, g, r in zip(("out", "qkv", "ctx"), got, fv.self_attention_fwd_plain(
            *args, num_heads=16, n_q=256)):
        _check_kernel(name, g, r)
    n_q = 64 * 65535 + 1  # 65,536 query tiles of 64 rows in one item
    tall = _rand(hopper, n_q, 8)
    with pytest.raises(RuntimeError, match="cudaError_t 1$"):
        fv.self_attention_fwd(tall, torch.zeros(n_q, device="cuda"),
                              _rand(hopper, 24, 8), _rand(hopper, 24),
                              _rand(hopper, 8, 8), _rand(hopper, 8),
                              num_heads=1, n_q=n_q)


def _b12_shape_inputs(gen, items, k, f, d):
    """x [items * k, d], mem [items * f, d] with ~15% missing fields and item
    0 without any, key bias, weights at std d^-1/2, dout."""
    mask = (torch.rand(items, f, device="cuda", generator=gen) > 0.15).float()
    mask[0] = 0.0
    x = _rand(gen, items * k, d)
    mem = (_rand(gen, items, f, d) * mask[..., None].bfloat16()).reshape(-1, d)
    kb = ((1.0 - mask) * -1e9).reshape(-1).contiguous()
    s = d ** -0.5
    w = {n: _rand(gen, *sh, std=s) for n, sh in (
        ("wqkv", (3 * d, d)), ("wq", (d, d)), ("wkv", (2 * d, d)),
        ("wo", (d, d)))}
    b = {n: _rand(gen, n_, std=0.1) for n, n_ in (
        ("bqkv", 3 * d), ("bq", d), ("bkv", 2 * d), ("bo", d))}
    dout = _rand(gen, items * k, d, std=0.1)
    return x, mem, kb, w, b, dout, (mask.sum(1) == 0).repeat_interleave(k)


@pytest.mark.parametrize("items,k,f,d,heads", [
    (16, 128, 128, 1024, 8), (16, 64, 64, 1024, 2), (8, 64, 64, 1024, 1),
    (64, 32, 14, 1020, 4)], ids=["kf128_hd128", "kf64_hd512", "hd1024",
                                 "d1020"])
def test_b12_takes_every_admitted_shape(hopper, items, k, f, d, heads):
    """B12s / B12c forward and backward at shapes supports_fused_train admits
    that the old kernels refused (C-7: K = F = 128 at hd 128, hd 512, one
    head of 1024; C-10: width 1020, rows not 16-byte aligned), against the
    plain versions, repeating bit for bit."""
    from unirec_tpu_torch.ops import fused_qformer_vjp as fv

    assert fv.supports_fused_train(k, d, heads, f)
    x, mem, kb, w, b, dout, empty = _b12_shape_inputs(hopper, items, k, f, d)
    zero = torch.zeros(x.shape[0], device="cuda")
    skw = dict(num_heads=heads, n_q=k)
    ckw = dict(skw, n_kv=f)
    sa = (x, zero, w["wqkv"], b["bqkv"], w["wo"], b["bo"])
    ca = (x, mem, kb, w["wq"], b["bq"], w["wkv"], b["bkv"], w["wo"], b["bo"])
    got = fv.self_attention_fwd(*sa, **skw)
    torch.cuda.synchronize()
    for name, g, r in zip(("out", "qkv", "ctx"), got,
                          fv.self_attention_fwd_plain(*sa, **skw)):
        _check_kernel(name, g, r)
    bargs = (got[1], w["wo"], zero, dout)
    dqkv = fv.self_attention_bwd(*bargs, **skw)
    torch.cuda.synchronize()
    _check_kernel("dqkv", dqkv, fv.self_attention_bwd_plain(*bargs, **skw))
    assert all(torch.equal(a, c) for a, c in
               zip(got, fv.self_attention_fwd(*sa, **skw)))
    assert torch.equal(dqkv, fv.self_attention_bwd(*bargs, **skw))
    got = fv.cross_attention_fwd(*ca, **ckw)
    torch.cuda.synchronize()
    for name, g, r in zip(("out", "q", "kv", "ctx"), got,
                          fv.cross_attention_fwd_plain(*ca, **ckw)):
        _check_kernel(name, g, r)
    bargs = (got[1], got[2], w["wo"], kb, dout)
    dq, dkv = fv.cross_attention_bwd(*bargs, **ckw)
    torch.cuda.synchronize()
    rq, rkv = fv.cross_attention_bwd_plain(*bargs, **ckw)
    _check_kernel("dq", dq, rq, noise_rows=empty)
    _check_kernel("dkv", dkv, rkv)
    again = fv.cross_attention_bwd(*bargs, **ckw)
    assert torch.equal(dq, again[0]) and torch.equal(dkv, again[1])


# -- B13 / B14: the user stage's streaming cross-attention ---------------------


def _flash_inputs(gen, b, lq, lkv, dtype, d=1024):
    """Merged-head q [B, Lq, D], k3 / v3 [B, Lkv, D], dO, and a per-key
    bias with ~15% masked keys and batch row 1 fully masked (a user whose
    whole history is missing from the cache)."""
    q, do = (torch.randn(b, lq, d, device="cuda", generator=gen).to(dtype)
             for _ in range(2))
    k3, v3 = (torch.randn(b, lkv, d, device="cuda", generator=gen).to(dtype)
              for _ in range(2))
    mask = (torch.rand(b, lkv, device="cuda", generator=gen) > 0.15).float()
    mask[1] = 0.0
    bias = ((1.0 - mask) * -1e9)[:, None, None, :]
    return q, k3, v3, do, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,lq,lkv", [(8, 64, 1600), (4, 50, 1000)],
                         ids=["user_shape", "ragged"])
def test_b13_matches_plain(hopper, dtype, b, lq, lkv):
    from unirec_tpu_torch.ops import attention as pa

    q, k3, v3, _, bias = _flash_inputs(hopper, b, lq, lkv, dtype)
    qh, kh, vh = (pa.split_heads(t, 16) for t in (q, k3, v3))
    before = pa.flash_cross_attention.launches
    out = pa.flash_cross_attention(qh, kh, vh, bias)
    torch.cuda.synchronize()
    assert pa.flash_cross_attention.launches == before + 1
    assert out.shape == (b, 16, lq, 64) and out.dtype == dtype
    _check_kernel("B13", out,
                  pa.flash_cross_attention_plain(qh, kh, vh, bias))
    assert torch.equal(out, pa.flash_cross_attention(qh, kh, vh, bias))
    # the fully masked row averages its real keys uniformly
    torch.testing.assert_close(out[1].float(), vh[1].float().mean(
        dim=1, keepdim=True).expand(16, lq, 64), atol=2e-2, rtol=0)
    # the dispatch takes B13 from FLASH_MIN_KV memory rows on
    pa.cross_attention(qh, kh, vh, bias)
    assert pa.flash_cross_attention.launches == before + 2 + (
        lkv >= pa.FLASH_MIN_KV)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,lq,lkv", [(8, 64, 1600), (4, 50, 1000)],
                         ids=["user_shape", "ragged"])
def test_b14_fwd_bwd_match_plain(hopper, dtype, b, lq, lkv):
    from unirec_tpu_torch.ops import attention as pa
    from unirec_tpu_torch.ops import flash_vjp as fl

    q, k3, v3, do, bias = _flash_inputs(hopper, b, lq, lkv, dtype)
    bias32 = pa.key_bias(bias, b, lkv, q.device)
    o, m, l = fl.flash_cross_fwd(q, k3, v3, bias32, 16)
    torch.cuda.synchronize()
    assert o.dtype == torch.float32  # for the backward's dsum
    ro, rm, rl = fl.flash_cross_fwd_plain(q, k3, v3, bias32, 16)
    _check_kernel("B14 o", o, ro)
    torch.testing.assert_close(m, rm, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(l, rl, rtol=1e-4, atol=0)
    dsum = fl.attention_dsum(do, o, 16)
    got = fl.flash_cross_bwd(q, k3, v3, bias32, do, m, l, dsum, 16)
    torch.cuda.synchronize()
    ref = fl.flash_cross_bwd_plain(q, k3, v3, bias32, do, m, l, dsum, 16)
    for name, g, r in zip(("dq", "dk3", "dv3"), got, ref):
        _check_kernel(f"B14 {name}", g, r)
    again = fl.flash_cross_bwd(q, k3, v3, bias32, do, m, l, dsum, 16)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    assert all(torch.equal(a, c) for a, c in
               zip((o, m, l), fl.flash_cross_fwd(q, k3, v3, bias32, 16)))


def test_b14_autograd_gradients_match_cpu(hopper):
    """The trainable proj-VJP on the card (bf16) against the same Function
    on the CPU (the plain versions), the output and all six gradients."""
    from unirec_tpu_torch.ops import flash_vjp as fl

    d = 1024
    q, mem, _, do, bias = _flash_inputs(hopper, 4, 64, 1000, torch.bfloat16)
    weights = [torch.randn(*s, device="cuda", generator=hopper) * 0.03
               for s in ((d, d), (d,), (d, d), (d,))]
    leaves = [t.clone().requires_grad_() for t in [q, mem] + weights]
    out = fl.flash_cross_attention_proj_vjp(*leaves, bias, num_heads=16)
    out.backward(do)
    cpu = [t.detach().cpu().requires_grad_() for t in leaves]
    ref = fl.flash_cross_attention_proj_vjp(*cpu, bias.cpu(), num_heads=16)
    ref.backward(do.cpu())
    _check_kernel("out", out.detach(), ref.detach().cuda())
    top = max(t.grad.float().norm().item() for t in cpu)
    for name, g, r in zip(("q", "mem", "wk", "bk", "wv", "bv"), leaves, cpu):
        if name == "bk":  # exactly 0 (a key bias shifts all of a query's
            # scores alike): both sides return rounding noise
            assert max(g.grad.float().norm().item(),
                       r.grad.float().norm().item()) <= 1e-3 * top
            continue
        _check_kernel(f"grad {name}", g.grad, r.grad.cuda(), tol=3e-2,
                      min_cos=0.999)


def test_flash_cross_wrappers_refuse_what_the_kernels_do_not_take(hopper):
    from unirec_tpu_torch.ops import attention as pa
    from unirec_tpu_torch.ops import flash_vjp as fl

    q, k3, v3, _, bias = _flash_inputs(hopper, 2, 8, 100, torch.bfloat16)
    # above 256 the chunked form runs; a head dim of 0 has no instance (its
    # empty rows may meet the row-alignment check first)
    with pytest.raises(ValueError, match=r"head_dim in \(16, .*256\)"):
        pa.check_head_dim("B14", 0)
    empty = _flash_inputs(hopper, 2, 8, 100, torch.bfloat16, d=0)
    with pytest.raises(ValueError):
        fl.flash_cross_fwd(*empty[:3], None, 2)
    with pytest.raises(ValueError):
        pa.flash_cross_attention(*(pa.split_heads(t, 2) for t in empty[:3]))
    with pytest.raises(ValueError):
        fl.flash_cross_attention_vjp(
            *(pa.split_heads(t, 2).detach() for t in empty[:3]))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fl.flash_cross_fwd(q.half(), k3.half(), v3.half(), None, 16)
    qh = pa.split_heads(q, 16).requires_grad_()
    with pytest.raises(RuntimeError, match="no gradient"):
        pa.flash_cross_attention(qh, pa.split_heads(k3, 16),
                                 pa.split_heads(v3, 16), bias)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 128, 8, 24, 256, 512, 264])
def test_b13_b14_take_other_head_dims(hopper, dtype, hd):
    """The streaming kernels at other head dims of a width of 1024 (hd 32,
    128, 256, and 512 in two chunks; 8 zero-padded to 16; hd 64 above) and
    at 16 heads of 24 (a width of 384, zero-padded to 32), over a ragged
    memory."""
    from unirec_tpu_torch.ops import attention as pa
    from unirec_tpu_torch.ops import flash_vjp as fl

    h, b, lkv = (1024 // hd if 1024 % hd == 0 else 16), 4, 1000
    q, k3, v3, do, bias = _flash_inputs(hopper, b, 64, lkv, dtype, d=h * hd)
    qh, kh, vh = (pa.split_heads(t, h) for t in (q, k3, v3))
    out = pa.flash_cross_attention(qh, kh, vh, bias)
    torch.cuda.synchronize()
    _check_kernel("B13", out, pa.flash_cross_attention_plain(qh, kh, vh, bias))
    bias32 = pa.key_bias(bias, b, lkv, q.device)
    o, m, l = fl.flash_cross_fwd(q, k3, v3, bias32, h)
    torch.cuda.synchronize()
    ro, rm, rl = fl.flash_cross_fwd_plain(q, k3, v3, bias32, h)
    _check_kernel("B14 o", o, ro)
    torch.testing.assert_close(m, rm, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(l, rl, rtol=1e-4, atol=0)
    dsum = fl.attention_dsum(do, o, h)
    got = fl.flash_cross_bwd(q, k3, v3, bias32, do, m, l, dsum, h)
    torch.cuda.synchronize()
    ref = fl.flash_cross_bwd_plain(q, k3, v3, bias32, do, m, l, dsum, h)
    for name, g, r in zip(("dq", "dk3", "dv3"), got, ref):
        _check_kernel(f"B14 {name}", g, r)


# -- B14p: trainable flash cross-attention over per-head tensors --------------


def _b14p_inputs(gen, b, h, lq, lkv, hd, dtype):
    """Per-head q, dO [B, H, Lq, hd], k / v [B, H, Lkv, hd], and a per-key
    bias with ~15% masked keys and batch row 1 masked whole."""
    q, do = (torch.randn(b, h, lq, hd, device="cuda", generator=gen).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, h, lkv, hd, device="cuda", generator=gen).to(dtype)
            for _ in range(2))
    mask = (torch.rand(b, lkv, device="cuda", generator=gen) > 0.15).float()
    mask[1] = 0.0
    return q, k, v, do, ((1.0 - mask) * -1e9)[:, None, None, :]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,lq,lkv,hd", [(8, 16, 64, 1600, 64),
                                           (4, 16, 64, 1000, 64),
                                           (2, 3, 16, 384, 32),
                                           (2, 2, 5, 200, 32),
                                           (64, 2, 64, 1600, 512),
                                           (4, 2, 1, 700, 512),
                                           (2, 2, 150, 400, 512),
                                           (4, 2, 64, 1000, 264)],
                         ids=["user_shape", "ragged", "jax_test", "odd",
                              "hd512_user_shape", "hd512_one_query",
                              "hd512_three_q_tiles", "hd264"])
def test_b14p_fwd_bwd_match_plain(hopper, dtype, b, h, lq, lkv, hd):
    from unirec_tpu_torch.ops import attention as pa
    from unirec_tpu_torch.ops import flash_vjp as fl

    q, k, v, do, bias = _b14p_inputs(hopper, b, h, lq, lkv, hd, dtype)
    bias32 = pa.key_bias(bias, b, lkv, q.device)
    before = (fl.flash_cross_vjp_fwd.launches, fl.flash_cross_vjp_bwd.launches)
    o, m, l = fl.flash_cross_vjp_fwd(q, k, v, bias32)
    torch.cuda.synchronize()
    assert o.dtype == torch.float32 and o.shape == q.shape
    ro, rm, rl = fl.flash_cross_vjp_fwd_plain(q, k, v, bias32)
    _check_kernel("B14p o", o, ro)
    torch.testing.assert_close(m, rm, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(l, rl, rtol=1e-4, atol=0)
    dsum = (do.float() * o).sum(-1).transpose(1, 2).contiguous()
    got = fl.flash_cross_vjp_bwd(q, k, v, bias32, do, m, l, dsum)
    torch.cuda.synchronize()
    assert (fl.flash_cross_vjp_fwd.launches, fl.flash_cross_vjp_bwd.launches
            ) == (before[0] + 1, before[1] + 1)
    ref = fl.flash_cross_vjp_bwd_plain(q, k, v, bias32, do, m, l, dsum)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        _check_kernel(f"B14p {name}", g, r)
    again = fl.flash_cross_vjp_bwd(q, k, v, bias32, do, m, l, dsum)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    assert all(torch.equal(a, c) for a, c in
               zip((o, m, l), fl.flash_cross_vjp_fwd(q, k, v, bias32)))
    # masked keys of a user with a valid key: exactly zero dk and dv (the
    # fully masked user's keys share its probability uniformly)
    masked = bias32 != 0
    masked[1] = False
    for g in got[1:]:
        assert (g.transpose(1, 2)[masked] == 0).all()
    # the fully masked user averages its keys
    torch.testing.assert_close(o[1], v[1].float().mean(1, keepdim=True)
                               .expand(h, lq, hd), atol=2e-2, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b13_b14_chunked_at_the_user_shape(hopper, dtype):
    """The chunked form at the 2-head user step's shape (64 users, 64
    queries over 1,600 rows, 2 heads of 512, merged heads; ~15% masked keys,
    user 1 masked whole): B13 and B14's forward and one-pass backward
    against their plain versions, (m, l) from the chunk-0 blocks to 1e-5,
    the masked user's uniform average, masked keys' zero dk / dv, identical
    bits on a repeat."""
    from unirec_tpu_torch.ops import attention as pa
    from unirec_tpu_torch.ops import flash_vjp as fl

    b, lq, lkv, h, hd = 64, 64, 1600, 2, 512
    q, k3, v3, do, bias = _flash_inputs(hopper, b, lq, lkv, dtype, d=h * hd)
    qh, kh, vh = (pa.split_heads(t, h) for t in (q, k3, v3))
    out = pa.flash_cross_attention(qh, kh, vh, bias)
    _check_kernel("B13", out, pa.flash_cross_attention_plain(qh, kh, vh, bias))
    assert torch.equal(out, pa.flash_cross_attention(qh, kh, vh, bias))
    bias32 = pa.key_bias(bias, b, lkv, q.device)
    o, m, l = fl.flash_cross_fwd(q, k3, v3, bias32, h)
    ro, rm, rl = fl.flash_cross_fwd_plain(q, k3, v3, bias32, h)
    _check_kernel("B14 o", o, ro)
    torch.testing.assert_close(m, rm, rtol=1e-5, atol=0)
    torch.testing.assert_close(l, rl, rtol=1e-5, atol=0)
    assert all(torch.equal(x, y) for x, y in
               zip((o, m, l), fl.flash_cross_fwd(q, k3, v3, bias32, h)))
    torch.testing.assert_close(
        o[1].reshape(lq, h, hd),
        v3[1].float().reshape(lkv, h, hd).mean(0, keepdim=True)
        .expand(lq, h, hd), atol=2e-2, rtol=0)
    dsum = fl.attention_dsum(do, o, h)
    got = fl.flash_cross_bwd(q, k3, v3, bias32, do, m, l, dsum, h)
    ref = fl.flash_cross_bwd_plain(q, k3, v3, bias32, do, m, l, dsum, h)
    for name, g, r in zip(("dq", "dk3", "dv3"), got, ref):
        _check_kernel(f"B14 {name}", g, r)
    again = fl.flash_cross_bwd(q, k3, v3, bias32, do, m, l, dsum, h)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    masked = bias32 != 0
    masked[1] = False
    for g in got[1:]:
        assert (g[masked] == 0).all()


@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 4)], ids=["gqa2", "mha"])
@pytest.mark.parametrize("hd", [300, 512])
def test_k1_b7b_chunked_bf16_stats_and_repeats(hopper, hq, hkv, hd):
    """K1 and B7b's dq in the chunked bf16 form over padded rows, GQA 2:1
    and 1:1: (m, l) of the chunk-0 blocks against the plain version at the
    B14p test's tolerances (m rtol 1e-5 with atol 1e-4, where m is near 0;
    l rtol 1e-4), o, dq, dk and dv at the bf16 gates, identical bits on a
    repeat."""
    b, l = 3, 300
    q, k, v, do = (torch.randn(b, l, n * hd, device="cuda", generator=hopper)
                   .to(torch.bfloat16) for n in (hq, hkv, hkv, hq))
    lengths = torch.tensor([300, 129, 1], device="cuda")
    mask = (torch.arange(l, device="cuda")[None] < lengths[:, None]).float()
    o, m, den = fc._k1(q, k, v, mask, hq, hkv, stats=True)
    ro, rm, rl = fc.flash_causal_attention_fwd_plain(
        q.float(), k.float(), v.float(), mask, hq, hkv)
    _close(o, ro, 1e-2, hd)
    torch.testing.assert_close(m, rm, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(den, rl, rtol=1e-4, atol=0)
    assert all(torch.equal(x, y) for x, y in zip(
        (o, m, den), fc._k1(q, k, v, mask, hq, hkv, stats=True)))
    dsum = fc.attention_dsum(do, o, hq).contiguous()
    args = (q, k, v, mask, do, m, den, dsum, hq, hkv)
    dq = fc.flash_causal_bwd_dq(*args)
    dk, dv = fc.flash_causal_bwd_dkv(*args)
    want = fc.flash_causal_attention_bwd_plain(
        q.float(), k.float(), v.float(), mask, do.float(), m, den, dsum, hq,
        hkv)
    _close(dq, want[0], 2e-2, hd, _single_key_rows(mask, hq))
    _close(dk, want[1], 2e-2, hd, _lone_key_rows(mask, hkv))
    _close(dv, want[2], 2e-2, hd)
    assert torch.equal(dq, fc.flash_causal_bwd_dq(*args))


def test_chunked_bf16_runs_every_chunk_count(hopper):
    """bf16 at hd 768 (three chunks; refused before C-19): K1 and dk / dv on
    tensor cores, dq in the cluster form, B14's forward on tensor cores and
    its one-pass backward in the cluster form, each against its plain
    version at the bf16 gates, the form each wrapper ran counted."""
    from unirec_tpu_torch.ops import attention as pa
    from unirec_tpu_torch.ops import flash_vjp as fl

    hd, hq, hkv, b, l = 768, 2, 1, 2, 100
    q, k, v, do = (torch.randn(b, l, n * hd, device="cuda", generator=hopper)
                   .to(torch.bfloat16) for n in (hq, hkv, hkv, hq))
    mask = torch.ones(b, l, device="cuda")
    mask[1, 60:] = 0.0
    counters = (fc.flash_causal_attention, fc.flash_causal_bwd_dq,
                fc.flash_causal_bwd_dkv, pa.launch_flash_cross_fwd,
                fl.launch_flash_cross_bwd)
    for fn in counters:
        fn.forms.clear()
    o, m, den = fc._k1(q, k, v, mask, hq, hkv, stats=True)
    ro = fc.flash_causal_attention_fwd_plain(q.float(), k.float(), v.float(),
                                             mask, hq, hkv)[0]
    _close(o, ro, 1e-2, hd)
    dsum = fc.attention_dsum(do, o, hq).contiguous()
    args = (q, k, v, mask, do, m, den, dsum, hq, hkv)
    dq = fc.flash_causal_bwd_dq(*args)
    dk, dv = fc.flash_causal_bwd_dkv(*args)
    want = fc.flash_causal_attention_bwd_plain(
        q.float(), k.float(), v.float(), mask, do.float(), m, den, dsum, hq,
        hkv)
    _close(dq, want[0], 2e-2, hd, _single_key_rows(mask, hq))
    _close(dk, want[1], 2e-2, hd, _lone_key_rows(mask, hkv))
    _close(dv, want[2], 2e-2, hd)
    # B14 at one head of 768: q and dO of the first query head
    q1, do1 = (t[..., :hd].contiguous() for t in (q, do))
    bias32 = pa.key_bias(None, b, l, q.device)
    got = fl.flash_cross_fwd(q1, k, v, bias32, 1)
    ref = fl.flash_cross_fwd_plain(q1, k, v, bias32, 1)
    _close(got[0], ref[0], 2e-2, hd)
    dsum1 = fl.attention_dsum(do1, got[0], 1).contiguous()
    grads = fl.flash_cross_bwd(q1, k, v, bias32, do1, got[1], got[2], dsum1,
                               1)
    refs = fl.flash_cross_bwd_plain(q1, k, v, bias32, do1, got[1], got[2],
                                    dsum1, 1)
    for g, r in zip(grads, refs):
        _close(g, r, 2e-2, hd)
    assert [dict(fn.forms) for fn in counters] == [
        {"tensor_cores": 1}, {"cluster": 1}, {"tensor_cores": 1},
        {"tensor_cores": 1}, {"cluster": 1}]


@pytest.mark.parametrize("hd,fwd,rows,keys", [
    (520, "tensor_cores", "cluster", "tensor_cores"),
    (768, "tensor_cores", "cluster", "tensor_cores"),
    (1024, "tensor_cores", "cluster", "tensor_cores"),
    (1280, "tensor_cores", "cluster", "scalar"),
    (1400, "cluster", "cluster", "scalar"),
    (1536, "cluster", "cluster", "scalar"),
    (2048, "cluster", "cluster", "scalar"),
    (2304, "scalar", "scalar", "scalar")])
def test_chunked_bf16_cluster_form(hopper, hd, fwd, rows, keys):
    """The bf16 chunked kernels on each side of the cluster form's bounds
    (``csrc/flash_chunked_cluster.cuh``: the forward at 6-8 chunks, the
    backward over rows at 3-8; 9 chunks, hd 2304, stays scalar; 520 and
    1400 end inside their last chunk), each wrapper's form counted: K1 and
    B7b over ragged rows with padded keys at GQA 2:1 and 1:1, then B13 and
    B14 (one head, merged layout) at two q tiles over a ragged memory of
    300 keys with user 1 masked whole; every output against its plain
    version at the bf16 gates (2e-2 of max|ref|, row cosine >= 0.9999; K1's
    o at 1e-2), identical bits on a repeat, exactly zero dk / dv at masked
    keys."""
    from unirec_tpu_torch.ops import attention as pa
    from unirec_tpu_torch.ops import flash_vjp as fl

    b16 = torch.bfloat16
    b, l = 3, 150
    lengths = torch.tensor([150, 70, 1], device="cuda")
    mask = (torch.arange(l, device="cuda")[None] < lengths[:, None]).float()
    mask[0, 20:45] = 0.0
    pad = mask == 0
    causal = (fc.flash_causal_attention, fc.flash_causal_bwd_dq,
              fc.flash_causal_bwd_dkv)
    for hq, hkv in ((2, 1), (2, 2)):
        q, k, v, do = (torch.randn(b, l, n * hd, device="cuda",
                                   generator=hopper).to(b16)
                       for n in (hq, hkv, hkv, hq))
        for fn in causal:
            fn.forms.clear()
        o, m, den = fc._k1(q, k, v, mask, hq, hkv, stats=True)
        ro = fc.flash_causal_attention_fwd_plain(
            q.float(), k.float(), v.float(), mask, hq, hkv)[0]
        _close(o, ro, 1e-2, hd)
        dsum = fc.attention_dsum(do, o, hq).contiguous()
        args = (q, k, v, mask, do, m, den, dsum, hq, hkv)
        dq = fc.flash_causal_bwd_dq(*args)
        dk, dv = fc.flash_causal_bwd_dkv(*args)
        torch.cuda.synchronize()
        assert [dict(fn.forms) for fn in causal] == [{fwd: 1}, {rows: 1},
                                                     {keys: 1}]
        want = fc.flash_causal_attention_bwd_plain(
            q.float(), k.float(), v.float(), mask, do.float(), m, den, dsum,
            hq, hkv)
        _close(dq, want[0], 2e-2, hd, _single_key_rows(mask, hq))
        _close(dk, want[1], 2e-2, hd, _lone_key_rows(mask, hkv))
        _close(dv, want[2], 2e-2, hd)
        assert bool((dk[pad] == 0).all()) and bool((dv[pad] == 0).all())
        assert all(torch.equal(x, y) for x, y in zip(
            (o, m, den), fc._k1(q, k, v, mask, hq, hkv, stats=True)))
        assert torch.equal(dq, fc.flash_causal_bwd_dq(*args))

    b, lq, lkv = 3, 70, 300
    q, k3, v3, do, bias = _flash_inputs(hopper, b, lq, lkv, b16, d=hd)
    qh, kh, vh = (pa.split_heads(t, 1) for t in (q, k3, v3))
    pa.launch_flash_cross_fwd.forms.clear()
    fl.launch_flash_cross_bwd.forms.clear()
    out = pa.flash_cross_attention(qh, kh, vh, bias)
    _check_kernel("B13", out, pa.flash_cross_attention_plain(qh, kh, vh, bias))
    assert torch.equal(out, pa.flash_cross_attention(qh, kh, vh, bias))
    bias32 = pa.key_bias(bias, b, lkv, q.device)
    o, m, l = fl.flash_cross_fwd(q, k3, v3, bias32, 1)
    ro, rm, rl = fl.flash_cross_fwd_plain(q, k3, v3, bias32, 1)
    _check_kernel("B14 o", o, ro)
    torch.testing.assert_close(m, rm, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(l, rl, rtol=1e-4, atol=0)
    assert all(torch.equal(x, y) for x, y in
               zip((o, m, l), fl.flash_cross_fwd(q, k3, v3, bias32, 1)))
    torch.testing.assert_close(o[1], v3[1].float().mean(0, keepdim=True)
                               .expand(lq, hd), atol=2e-2, rtol=0)
    dsum = fl.attention_dsum(do, o, 1)
    got = fl.flash_cross_bwd(q, k3, v3, bias32, do, m, l, dsum, 1)
    ref = fl.flash_cross_bwd_plain(q, k3, v3, bias32, do, m, l, dsum, 1)
    for name, g, r in zip(("dq", "dk3", "dv3"), got, ref):
        _check_kernel(f"B14 {name}", g, r)
    again = fl.flash_cross_bwd(q, k3, v3, bias32, do, m, l, dsum, 1)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    masked = bias32 != 0
    masked[1] = False
    for g in got[1:]:
        assert (g[masked] == 0).all()
    assert set(pa.launch_flash_cross_fwd.forms) == {fwd}
    assert set(fl.launch_flash_cross_bwd.forms) == {rows}


def _hold_fp32(name, out, ref):
    """The float32 chunked gates: max|d| <= 1e-5 of max|ref| and, over the
    rows (last dim) where ref is nonzero, cosine >= 0.9999."""
    a, b = out.float(), ref.float()
    assert bool(torch.isfinite(a).all()), name
    rel = ((a - b).abs().max() / b.abs().max()).item()
    assert rel <= 1e-5, (name, rel)
    a2, b2 = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    live = b2.abs().amax(-1) > 0
    cos = torch.nn.functional.cosine_similarity(a2[live].double(),
                                                b2[live].double(), dim=-1)
    assert cos.min().item() >= 0.9999, (name, cos.min().item())


@pytest.mark.parametrize("hd,form", [
    (320, "cluster_tf32"), (512, "cluster_tf32"), (768, "cluster_tf32"),
    (1024, "cluster_tf32"), (1280, "cluster_tf32"), (1400, "cluster_tf32"),
    (1792, "cluster_tf32"), (2048, "cluster_tf32"), (2304, "scalar")])
def test_chunked_fp32_runs_every_chunk_count(hopper, hd, form):
    """float32 at every chunk count of the 3xTF32 cluster form (2-8 chunks;
    320 and 1400 end inside their last chunk) and at 9 (2304, the scalar
    form): K1 and B7b's dq over ragged rows with padded keys at GQA 2:1,
    then B13, B14 (one head, merged layout) and B14p (per-head) at two q
    tiles over a ragged memory of 300 keys with user 1 masked whole (the
    forward's key splits and the backward's dk / dv partials); every output
    within 1e-5 of max|ref| of its plain version with row cosine >= 0.9999,
    identical bits on a repeat, each wrapper's form counted (B7b's dk / dv
    scalar)."""
    from unirec_tpu_torch.ops import attention as pa
    from unirec_tpu_torch.ops import flash_vjp as fl

    f32 = torch.float32
    b, l, hq, hkv = 3, 150, 2, 1
    lengths = torch.tensor([150, 70, 1], device="cuda")
    mask = (torch.arange(l, device="cuda")[None] < lengths[:, None]).float()
    mask[0, 20:45] = 0.0
    causal = (fc.flash_causal_attention, fc.flash_causal_bwd_dq,
              fc.flash_causal_bwd_dkv)
    q, k, v, do = (torch.randn(b, l, n * hd, device="cuda", generator=hopper)
                   for n in (hq, hkv, hkv, hq))
    for fn in causal:
        fn.forms.clear()
    o, m, den = fc._k1(q, k, v, mask, hq, hkv, stats=True)
    ro, rm, rl = fc.flash_causal_attention_fwd_plain(q, k, v, mask, hq, hkv)
    for name, got, ref in (("K1 o", o, ro), ("K1 m", m, rm), ("K1 l", den,
                                                            rl)):
        _hold_fp32(name, got, ref)
    dsum = fc.attention_dsum(do, o, hq).contiguous()
    args = (q, k, v, mask, do, m, den, dsum, hq, hkv)
    dq = fc.flash_causal_bwd_dq(*args)
    fc.flash_causal_bwd_dkv(*args)
    torch.cuda.synchronize()
    assert [dict(fn.forms) for fn in causal] == [{form: 1}, {form: 1},
                                                 {"scalar": 1}]
    want = fc.flash_causal_attention_bwd_plain(q, k, v, mask, do, m, den,
                                               dsum, hq, hkv)
    # rows over one valid key: their exact dq is 0, both sides noise
    noise = _single_key_rows(mask, hq).reshape(b, l, hq)
    _hold_fp32("B7b dq", dq.reshape(b, l, hq, hd)[~noise],
               want[0].reshape(b, l, hq, hd)[~noise])
    assert all(torch.equal(x, y) for x, y in zip(
        (o, m, den), fc._k1(q, k, v, mask, hq, hkv, stats=True)))
    assert torch.equal(dq, fc.flash_causal_bwd_dq(*args))

    b, lq, lkv = 3, 70, 300
    q, k3, v3, do, bias = _flash_inputs(hopper, b, lq, lkv, f32, d=hd)
    qh, kh, vh = (pa.split_heads(t, 1) for t in (q, k3, v3))
    pa.launch_flash_cross_fwd.forms.clear()
    fl.launch_flash_cross_bwd.forms.clear()
    out = pa.flash_cross_attention(qh, kh, vh, bias)
    _hold_fp32("B13", out, pa.flash_cross_attention_plain(qh, kh, vh, bias))
    assert torch.equal(out, pa.flash_cross_attention(qh, kh, vh, bias))
    bias32 = pa.key_bias(bias, b, lkv, q.device)
    o, m, l = fl.flash_cross_fwd(q, k3, v3, bias32, 1)
    for name, got, ref in zip(("B14 o", "B14 m", "B14 l"), (o, m, l),
                              fl.flash_cross_fwd_plain(q, k3, v3, bias32, 1)):
        _hold_fp32(name, got, ref)
    assert all(torch.equal(x, y) for x, y in
               zip((o, m, l), fl.flash_cross_fwd(q, k3, v3, bias32, 1)))
    dsum = fl.attention_dsum(do, o, 1)
    got = fl.flash_cross_bwd(q, k3, v3, bias32, do, m, l, dsum, 1)
    ref = fl.flash_cross_bwd_plain(q, k3, v3, bias32, do, m, l, dsum, 1)
    for name, g, r in zip(("dq", "dk3", "dv3"), got, ref):
        _hold_fp32(f"B14 {name}", g, r)
    again = fl.flash_cross_bwd(q, k3, v3, bias32, do, m, l, dsum, 1)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    masked = bias32 != 0
    masked[1] = False
    for g in got[1:]:
        assert (g[masked] == 0).all()
    qp, kp, vp, dop = (pa.split_heads(t, 1).contiguous()
                       for t in (q, k3, v3, do))
    op, mp, lp = fl.flash_cross_vjp_fwd(qp, kp, vp, bias32)
    for name, g, r in zip(("B14p o", "B14p m", "B14p l"), (op, mp, lp),
                          fl.flash_cross_vjp_fwd_plain(qp, kp, vp, bias32)):
        _hold_fp32(name, g, r)
    dsum_p = (dop * op).sum(-1).transpose(1, 2).contiguous()
    got = fl.flash_cross_vjp_bwd(qp, kp, vp, bias32, dop, mp, lp, dsum_p)
    ref = fl.flash_cross_vjp_bwd_plain(qp, kp, vp, bias32, dop, mp, lp,
                                       dsum_p)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        _hold_fp32(f"B14p {name}", g, r)
    assert all(torch.equal(x, y) for x, y in zip(got, fl.flash_cross_vjp_bwd(
        qp, kp, vp, bias32, dop, mp, lp, dsum_p)))
    # B13, B14 and B14p's backward twice each, B14p's forward once
    assert dict(pa.launch_flash_cross_fwd.forms) == {form: 5}
    assert dict(fl.launch_flash_cross_bwd.forms) == {form: 4}


def test_chunked_fp32_causal_key_splits(hopper):
    """float32 K1 (with (m, l)) and B7b's dq at B 2, L 512, 4 query / 2 key
    heads of 512 over rows of 512 and 301 keys, where the 3xTF32 cluster
    form splits each row's key tiles (``chunked_plan``) and merges
    (K1) or adds (dq) the splits: within 1e-5 of max|ref| of the plain
    versions with row cosine >= 0.9999, identical bits on a repeat."""
    from unirec_tpu_torch.ops import attention as pa

    b, l, hq, hkv, hd = 2, 512, 4, 2, 512
    for kind in (pa.CHUNKED_FWD, pa.CHUNKED_ROWS):
        assert pa.chunked_plan(torch.zeros(1, device="cuda"), kind, b, hq, l,
                               l, hd, "cluster_tf32", causal=True)[0] >= 2
    q, k, v, do = (torch.randn(b, l, n * hd, device="cuda", generator=hopper)
                   for n in (hq, hkv, hkv, hq))
    mask = (torch.arange(l, device="cuda")[None]
            < torch.tensor([512, 301], device="cuda")[:, None]).float()
    o, m, den = fc._k1(q, k, v, mask, hq, hkv, stats=True)
    ref = fc.flash_causal_attention_fwd_plain(q, k, v, mask, hq, hkv)
    for name, got, want in zip(("o", "m", "l"), (o, m, den), ref):
        _hold_fp32(f"K1 {name}", got, want)
    assert all(torch.equal(x, y) for x, y in zip(
        (o, m, den), fc._k1(q, k, v, mask, hq, hkv, stats=True)))
    dsum = fc.attention_dsum(do, o, hq).contiguous()
    args = (q, k, v, mask, do, m, den, dsum, hq, hkv)
    dq = fc.flash_causal_bwd_dq(*args)
    want = fc.flash_causal_attention_bwd_plain(q, k, v, mask, do, m, den,
                                               dsum, hq, hkv)[0]
    noise = _single_key_rows(mask, hq).reshape(b, l, hq)
    _hold_fp32("B7b dq", dq.reshape(b, l, hq, hd)[~noise],
               want.reshape(b, l, hq, hd)[~noise])
    assert torch.equal(dq, fc.flash_causal_bwd_dq(*args))


@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 4)], ids=["gqa2", "mha"])
@pytest.mark.parametrize("hd", [320, 512, 768])
def test_chunk_bwd_keys_tc(hopper, hq, hkv, hd):
    """B7b's dk / dv on tensor cores (chunk_bwd_keys_tc) over ragged rows
    with padded keys, GQA 2:1 and 1:1: dk and dv at the bf16 gates against
    the plain version, exactly zero at padded keys, identical bits on a
    repeat, the tensor-core form counted; float32 on the same inputs runs
    the scalar form, within 1e-5 of its plain version and identical on a
    repeat."""
    b, l = 3, 300
    q, k, v, do = (torch.randn(b, l, n * hd, device="cuda", generator=hopper)
                   for n in (hq, hkv, hkv, hq))
    lengths = torch.tensor([300, 129, 1], device="cuda")
    mask = (torch.arange(l, device="cuda")[None] < lengths[:, None]).float()
    mask[0, 40:70] = 0.0
    pad = mask == 0
    for dtype, tol, form in ((torch.bfloat16, 2e-2, "tensor_cores"),
                             (torch.float32, 1e-5, "scalar")):
        qt, kt, vt, dot = (t.to(dtype) for t in (q, k, v, do))
        o, m, den = fc._k1(qt, kt, vt, mask, hq, hkv, stats=True)
        dsum = fc.attention_dsum(dot, o, hq).contiguous()
        args = (qt, kt, vt, mask, dot, m, den, dsum, hq, hkv)
        fc.flash_causal_bwd_dkv.forms.clear()
        dk, dv = fc.flash_causal_bwd_dkv(*args)
        torch.cuda.synchronize()
        assert dict(fc.flash_causal_bwd_dkv.forms) == {form: 1}
        want = fc.flash_causal_attention_bwd_plain(
            *(t.float() for t in (qt, kt, vt)), mask, dot.float(), m, den,
            dsum, hq, hkv)
        _close(dk, want[1], tol, hd, _lone_key_rows(mask, hkv))
        _close(dv, want[2], tol, hd)
        assert bool((dk[pad] == 0).all()) and bool((dv[pad] == 0).all())
        again = fc.flash_causal_bwd_dkv(*args)
        assert torch.equal(dk, again[0]) and torch.equal(dv, again[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b14p_autograd_gradients_match_cpu(hopper, dtype):
    """flash_cross_attention_vjp on the card against the same Function on
    the CPU (the plain versions): the output and the three gradients."""
    from unirec_tpu_torch.ops import flash_vjp as fl

    q, k, v, do, bias = _b14p_inputs(hopper, 4, 16, 64, 1000, 64, dtype)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fl.flash_cross_attention_vjp(*leaves, bias)
    grads = torch.autograd.grad(out, leaves, do)
    cpu = [t.detach().cpu().requires_grad_() for t in (q, k, v)]
    ref = fl.flash_cross_attention_vjp(*cpu, bias.cpu())
    ref_grads = torch.autograd.grad(ref, cpu, do.cpu())
    _check_kernel("out", out.detach(), ref.detach().cuda())
    for name, g, r in zip("qkv", grads, ref_grads):
        _check_kernel(f"grad {name}", g, r.cuda())


@pytest.mark.parametrize("m,n,k,epi,chunk", [
    (32 * 1001, 3 * D, D, "bias", D),
    (32 * 1001, INTER, D, "bias_f32", D),
    (32 * 1001, D, D, "bias_resid", D),
    (32 * 1001, D, INTER, "chunked_resid", INTER),
    (32 * 1001, D, INTER, "chunked_resid", 1024),
    (32 * 4096, INTER, D, "bias_f32", D),
    (32 * 4096, D, INTER, "chunked_resid", INTER),
    (32 * 1001, D, INTER, "chunked", INTER),
    (32 * 1001, D, INTER, "chunked", 1024),
    (4096, QWEN_QKV, QWEN_D, "plain", QWEN_D),
    (4096, QWEN_D, QWEN_I, "plain", QWEN_I),
    (1000, 2 * QWEN_D, QWEN_D, "plain", QWEN_D),
    (4096, QWEN_I, QWEN_D, "swiglu", QWEN_D),
    (1000, QWEN_I, QWEN_D, "swiglu", QWEN_D)])
def test_int8_gemm_matches_plain_bit_for_bit(hopper, m, n, k, epi, chunk):
    """The int8 TMA + wgmma GEMM of B4-B6 and B8-B9b (csrc/gemm_wide.cuh)
    in each of its epilogues, through the test entry unirec_gemm_q_test,
    against its plain form (chip_smoke.gemm_q_plain: the exact product,
    then the same fp32 roundings): the same bits, at B4-B6's and the Qwen3
    serving products; the SwiGLU epilogue's row maxima equal to the amax of
    |h| over each row; a repeat gives the same bits."""
    from unirec_tpu_torch.ops._build import check, load_kernels

    g = hopper
    wn = 2 * n if epi == "swiglu" else n
    a = torch.randint(-127, 128, (m, k), device="cuda", generator=g,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (wn, k), device="cuda", generator=g,
                      dtype=torch.int8)
    groups = k // chunk if epi.startswith("chunked") else 1
    rs = torch.rand(m, groups, device="cuda", generator=g) * 1e-3
    cs = torch.rand(wn, device="cuda", generator=g) * 1e-2
    bias = _vec(g, n)
    resid = _rand(g, m, n)
    dtype = torch.bfloat16 if epi in ("bias", "plain") else torch.float32
    outs = [torch.empty(m, n, device="cuda", dtype=dtype) for _ in range(2)]
    maxes = [torch.zeros(m, device="cuda") for _ in range(2)]
    for out, mx in zip(outs, maxes):
        check(load_kernels().lib.unirec_gemm_q_test(
            chip_smoke.GEMM_Q_EPIS.index(epi), a.data_ptr(), w.data_ptr(),
            rs.data_ptr(), groups, cs.data_ptr(), bias.data_ptr(),
            resid.data_ptr(), out.data_ptr(), mx.data_ptr(), m, n, k, chunk,
            torch.cuda.current_stream().cuda_stream), "unirec_gemm_q_test")
    ref = chip_smoke.gemm_q_plain(epi, a, w, rs, cs, bias, resid, chunk)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and torch.equal(maxes[0], maxes[1])
    if epi == "swiglu":
        assert torch.equal(outs[0], ref[0])
        assert torch.equal(maxes[0], outs[0].abs().amax(dim=1))
    else:
        assert torch.equal(outs[0], ref)


@pytest.mark.parametrize("d", [1020, 1032])
def test_blocks_take_widths_off_16_byte_rows(hopper, d):
    """B1-B6 at hidden 1020 (no multiple of 8 bf16 values: every product on
    gemm_wide.cuh's edge kernel) and 1032 (no multiple of 16 int8 codes:
    B4-B6's products on its int8 edge kernel), 4 heads, 64 items with
    missing fields, against their plain versions, repeating bit for bit
    (C-10)."""
    g = hopper
    items, heads = 64, 4
    x = _rand(g, items, K, d)
    mask = _missing_mask(g, items)
    mem = _rand(g, items, F, d) * mask[..., None].bfloat16()
    key_bias = ((1.0 - mask) * fq.NEG_INF).contiguous()
    sw = dict(wqkv=_rand(g, 3 * d, d, std=0.03), bqkv=_vec(g, 3 * d),
              wo=_rand(g, d, d, std=0.03), bo=_vec(g, d),
              ln_gamma=_vec(g, d, 1.0), ln_beta=_vec(g, d))
    cw = dict(wq=_rand(g, d, d, std=0.03), bq=_vec(g, d),
              wkv=_rand(g, 2 * d, d, std=0.03), bkv=_vec(g, 2 * d),
              wo=_rand(g, d, d, std=0.03), bo=_vec(g, d),
              ln_gamma=_vec(g, d, 1.0), ln_beta=_vec(g, d))
    fw = dict(w1=_rand(g, INTER, d, std=0.03), b1=_vec(g, INTER),
              w2=_rand(g, d, INTER, std=0.02), b2=_vec(g, d),
              ln_gamma=_vec(g, d, 1.0), ln_beta=_vec(g, d))

    def q(ws):
        out = dict(ws)
        for name, scale in (("wqkv", "sqkv"), ("wo", "so"), ("wq", "sq"),
                            ("wkv", "skv"), ("w1", "s1"), ("w2", "s2")):
            if name in ws:
                out[name], out[scale] = pq.quantize_weight(ws[name])
        return out

    sk = dict(num_heads=heads, n_q=K)
    ck = dict(sk, n_kv=F)
    for mod, sfx, (s_w, c_w, f_w) in ((fq, "", (sw, cw, fw)),
                                      (pq, "_q", (q(sw), q(cw), q(fw)))):
        for fn, args, w, kw in (
                ("fused_self_attention_block", (x,), s_w, sk),
                ("fused_cross_attention_block", (x, mem, key_bias), c_w, ck),
                ("fused_ffn_block", (x,), f_w, {})):
            kern = getattr(mod, fn + sfx)
            before = kern.launches
            out = kern(*args, **w, **kw)
            torch.cuda.synchronize()
            assert kern.launches == before + 1
            _check_block(out, getattr(mod, fn + sfx + "_plain")(*args, **w,
                                                                **kw))
            assert torch.equal(out, kern(*args, **w, **kw))


# -- B15: packed item attention ---------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_q,n_kv,hd", [(32, 32, 64), (32, 14, 64),
                                         (2, 14, 32), (2, 32, 64),
                                         (32, 14, 32), (32, 14, 8),
                                         (32, 14, 24)])
def test_b15_matches_plain(hopper, dtype, n_q, n_kv, hd):
    """1001 items (a ragged last block), 16 heads, read through per-head
    views of merged [items, L, 16 * hd] tensors; ~15% missing fields and 9
    items with none, which average their own values."""
    from unirec_tpu_torch.ops import attention as pa
    from unirec_tpu_torch.ops import packed_attention as pp

    items, h = 1001, 16

    def rand(n):
        return pa.split_heads(torch.randn(items, n, h * hd, device="cuda",
                                          generator=hopper).to(dtype), h)

    q, k, v = rand(n_q), rand(n_kv), rand(n_kv)
    mask = (torch.rand(items, n_kv, device="cuda", generator=hopper)
            > 0.15).float()
    mask[::125] = 0.0
    bias = ((1.0 - mask) * -1e9)[:, None, None, :]
    before = pp.packed_item_attention.launches
    out = pp.packed_item_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert pp.packed_item_attention.launches == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    _check_kernel("B15", out, pp.packed_item_attention_plain(q, k, v, bias))
    assert torch.equal(out, pp.packed_item_attention(q, k, v, bias))
    none = mask.sum(1) == 0
    torch.testing.assert_close(out[none].float(), v[none].float().mean(
        2, keepdim=True).expand(-1, -1, n_q, -1), atol=2e-2, rtol=0)
    _check_kernel("B15 no bias", pp.packed_item_attention(q, k, v),
                  pp.packed_item_attention_plain(q, k, v))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("items,n_q,n_kv,hd", [
    (4096, 32, 32, 64), (4096, 32, 14, 64), (256, 32, 14, 256),
    (256, 32, 14, 512), (64, 128, 512, 64), (256, 2, 600, 32)])
def test_b15_takes_any_head_dim_and_fields(hopper, dtype, items, n_q, n_kv,
                                           hd):
    """B15 at the sweep's two shapes and at shapes the first kernel refused
    (C-8): head dims 256 and 512, K = 128 over 512 keys, K = 2 over 600, 16
    heads, contiguous per-head tensors with ~15% missing keys; against the
    plain version, repeating bit for bit, rows rounded off 16-byte
    boundaries read right."""
    from unirec_tpu_torch.ops import packed_attention as pp

    h = 16
    q, k, v = (torch.randn(items, h, n, hd, device="cuda",
                           generator=hopper).to(dtype)
               for n in (n_q, n_kv, n_kv))
    mask = (torch.rand(items, n_kv, device="cuda", generator=hopper)
            > 0.15).float()
    mask[::50] = 0.0
    bias = ((1.0 - mask) * -1e9)[:, None, None, :]
    out = pp.packed_item_attention(q, k, v, bias)
    torch.cuda.synchronize()
    _check_kernel("B15", out, pp.packed_item_attention_plain(q, k, v, bias))
    assert torch.equal(out, pp.packed_item_attention(q, k, v, bias))
    none = mask.sum(1) == 0
    torch.testing.assert_close(out[none].float(), v[none].float().mean(
        2, keepdim=True).expand(-1, -1, n_q, -1), atol=2e-2, rtol=0)


def test_b15_refuses_what_the_kernel_does_not_take(hopper):
    """Other dtypes, K not dividing 128 and a strided head dimension are
    refused; rows off 16-byte boundaries and head dims above 128 are taken
    (the first kernel refused them)."""
    from unirec_tpu_torch.ops import packed_attention as pp

    q = torch.randn(4, 2, 32, 64, device="cuda", generator=hopper)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        pp.packed_item_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="divide 128"):
        pp.packed_item_attention(q[:, :, :24], q, q)
    with pytest.raises(ValueError, match="contiguous"):
        pp.packed_item_attention(q[..., ::2], q[..., ::2], q[..., ::2])
    odd = torch.randn(4 * 2 * 32 * 63 + 1, device="cuda")[1:].view(
        4, 2, 32, 63)
    _check_kernel("B15 at rows off 16-byte boundaries",
                  pp.packed_item_attention(odd, odd, odd),
                  pp.packed_item_attention_plain(odd, odd, odd))
    wide = torch.randn(4, 2, 32, 300, device="cuda", generator=hopper)
    _check_kernel("B15 at hd 300", pp.packed_item_attention(wide, wide, wide),
                  pp.packed_item_attention_plain(wide, wide, wide))


@pytest.mark.parametrize("hd", [8, 24, 64, 128, 256])
@pytest.mark.parametrize("lq", [64, 1, 200])
def test_flash_cross_bf16_tensor_core_kernels(hopper, hd, lq):
    """The bf16 forward and one-pass backward (B14p's entries; B13 and B14
    share them) at every head-dim tiling, at one q tile, one query and four
    q tiles (the partial dk / dv and their sum), over a 1,000-key memory
    whose last key tile is ragged at both tile sizes: against the plain
    versions, bit for bit on a repeat, the fully masked user's uniform
    average, and exactly zero dk / dv at the masked keys of users with a
    valid key."""
    from unirec_tpu_torch.ops import attention as pa
    from unirec_tpu_torch.ops import flash_vjp as fl

    b, h, lkv = 3, 4, 1000
    q, k, v, do, bias = _b14p_inputs(hopper, b, h, lq, lkv, hd,
                                     torch.bfloat16)
    bias32 = pa.key_bias(bias, b, lkv, q.device)
    o, m, l = fl.flash_cross_vjp_fwd(q, k, v, bias32)
    torch.cuda.synchronize()
    ro, rm, rl = fl.flash_cross_vjp_fwd_plain(q, k, v, bias32)
    _check_kernel("o", o, ro)
    torch.testing.assert_close(m, rm, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(l, rl, rtol=1e-5, atol=0)
    torch.testing.assert_close(o[1], v[1].float().mean(1, keepdim=True)
                               .expand(h, lq, hd), atol=2e-2, rtol=0)
    o13 = pa.flash_cross_attention(q, k, v, bias)
    _check_kernel("B13", o13, pa.flash_cross_attention_plain(q, k, v, bias))
    dsum = (do.float() * o).sum(-1).transpose(1, 2).contiguous()
    got = fl.flash_cross_vjp_bwd(q, k, v, bias32, do, m, l, dsum)
    torch.cuda.synchronize()
    ref = fl.flash_cross_vjp_bwd_plain(q, k, v, bias32, do, m, l, dsum)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        _check_kernel(name, g, r)
    again = fl.flash_cross_vjp_bwd(q, k, v, bias32, do, m, l, dsum)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    assert all(torch.equal(x, y) for x, y in
               zip((o, m, l), fl.flash_cross_vjp_fwd(q, k, v, bias32)))
    masked = bias32 != 0
    masked[1] = False
    assert all(bool((g.transpose(1, 2)[masked] == 0).all()) for g in got[1:])


TF32_HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128, 256, 8, 24)


def _rows32(name, out, ref, hd, noise_rows=None):
    """A float32 output of the 3xTF32 kernels against its plain version:
    max|d| <= 1e-5 max|ref| and per-row cosine >= 0.9999 over the rows of
    width hd where ref is nonzero, but for ``noise_rows``."""
    a, b = out.float(), ref.float()
    assert bool(torch.isfinite(a).all()), name
    rel = ((a - b).abs().max() / b.abs().max()).item()
    assert rel <= 1e-5, (name, rel)
    a2, b2 = a.reshape(-1, hd), b.reshape(-1, hd)
    live = b2.abs().amax(-1) > 0
    if noise_rows is not None:
        live &= ~noise_rows
    cos = torch.nn.functional.cosine_similarity(a2[live], b2[live], dim=-1)
    assert cos.min().item() >= 0.9999, (name, cos.min().item())


@pytest.mark.parametrize("hd", TF32_HEAD_DIMS)
@pytest.mark.parametrize("lq", [64, 1, 200])
def test_flash_cross_fp32_tf32_kernels(hopper, hd, lq):
    """The float32 forward and one-pass backward in 3xTF32 (B14p's entries;
    B13 and B14 share them) at every head-dim instance and the padded 8 and
    24, at one q tile, one query and four q tiles (the float32 partial dk /
    dv and their sum), over a 1,000-key memory whose last key tile is
    ragged: against the plain versions at 1e-5 and row cosine 0.9999, the
    form counted "tf32", bit for bit on a repeat, the fully masked user's
    uniform average, and exactly zero dk / dv at the masked keys of users
    with a valid key."""
    from unirec_tpu_torch.ops import attention as pa
    from unirec_tpu_torch.ops import flash_vjp as fl

    b, h, lkv = 3, 4, 1000
    q, k, v, do, bias = _b14p_inputs(hopper, b, h, lq, lkv, hd,
                                     torch.float32)
    bias32 = pa.key_bias(bias, b, lkv, q.device)
    pa.launch_flash_cross_fwd.forms.clear()
    fl.launch_flash_cross_bwd.forms.clear()
    o, m, l = fl.flash_cross_vjp_fwd(q, k, v, bias32)
    torch.cuda.synchronize()
    ro, rm, rl = fl.flash_cross_vjp_fwd_plain(q, k, v, bias32)
    _rows32("o", o, ro, hd)
    torch.testing.assert_close(m, rm, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(l, rl, rtol=1e-5, atol=0)
    torch.testing.assert_close(o[1], v[1].mean(1, keepdim=True)
                               .expand(h, lq, hd), atol=1e-5, rtol=0)
    o13 = pa.flash_cross_attention(q, k, v, bias)
    _rows32("B13", o13, pa.flash_cross_attention_plain(q, k, v, bias), hd)
    dsum = (do * o).sum(-1).transpose(1, 2).contiguous()
    got = fl.flash_cross_vjp_bwd(q, k, v, bias32, do, m, l, dsum)
    torch.cuda.synchronize()
    ref = fl.flash_cross_vjp_bwd_plain(q, k, v, bias32, do, m, l, dsum)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        _rows32(name, g, r, hd)
    assert dict(pa.launch_flash_cross_fwd.forms) == {"tf32": 2}
    assert dict(fl.launch_flash_cross_bwd.forms) == {"tf32": 1}
    again = fl.flash_cross_vjp_bwd(q, k, v, bias32, do, m, l, dsum)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    assert all(torch.equal(x, y) for x, y in
               zip((o, m, l), fl.flash_cross_vjp_fwd(q, k, v, bias32)))
    assert torch.equal(o13, pa.flash_cross_attention(q, k, v, bias))
    masked = bias32 != 0
    masked[1] = False
    assert all(bool((g.transpose(1, 2)[masked] == 0).all()) for g in got[1:])


@pytest.mark.parametrize("hq,hkv", [(4, 2), (3, 1), (4, 4)],
                         ids=["gqa2", "gqa3", "mha"])
@pytest.mark.parametrize("hd", TF32_HEAD_DIMS)
def test_b7b_fp32_tf32_kernels(hopper, hd, hq, hkv):
    """B7b's float32 dq and dk / dv in 3xTF32 at every head-dim instance
    and the padded 8 and 24, GQA 2:1 and 3:1 and MHA, over right-padded rows
    (a key tile that is all padding, rows of one key, a ragged last tile):
    against the plain version at 1e-5 and row cosine 0.9999 from K1's m and
    l, the forms counted "tf32", bit for bit on a repeat, exactly zero dk /
    dv at padded keys."""
    b, l = 4, 300
    q, k, v, do = (torch.randn(b, l, h * hd, device="cuda", generator=hopper)
                   for h in (hq, hkv, hkv, hq))
    lengths = torch.tensor([1, 60, 173, 300], device="cuda")
    mask = (torch.arange(l, device="cuda")[None] < lengths[:, None]).float()
    o, m, den = fc._k1(q, k, v, mask, hq, hkv, stats=True)
    dsum = fc.attention_dsum(do, o, hq).contiguous()
    args = (q, k, v, mask, do, m, den, dsum, hq, hkv)
    for fn in (fc.flash_causal_bwd_dq, fc.flash_causal_bwd_dkv):
        fn.forms.clear()
    dq = fc.flash_causal_bwd_dq(*args)
    dk, dv = fc.flash_causal_bwd_dkv(*args)
    torch.cuda.synchronize()
    assert dict(fc.flash_causal_bwd_dq.forms) == {"tf32": 1}
    assert dict(fc.flash_causal_bwd_dkv.forms) == {"tf32": 1}
    want = fc.flash_causal_attention_bwd_plain(q, k, v, mask, do, m, den,
                                               dsum, hq, hkv)
    _rows32("dq", dq, want[0], hd, _single_key_rows(mask, hq))
    _rows32("dk", dk, want[1], hd, _lone_key_rows(mask, hkv))
    _rows32("dv", dv, want[2], hd)
    assert torch.equal(dq, fc.flash_causal_bwd_dq(*args))
    again = fc.flash_causal_bwd_dkv(*args)
    assert torch.equal(dk, again[0]) and torch.equal(dv, again[1])
    padded = mask == 0
    assert (dk[padded] == 0).all() and (dv[padded] == 0).all()


# -- the fp32 forms of B1-B6 and B12 ------------------------------------------


def _inputs32(g, items):
    """float32 x and mem (~15% missing fields, >= 8 items with none), the
    key bias, and float32 weights of B1-B3 (and their int8 forms)."""
    x = _rand(g, items, K, D, dtype=torch.float32)
    mask = _missing_mask(g, items)
    mem = _rand(g, items, F, D, dtype=torch.float32) * mask[..., None]
    key_bias = ((1.0 - mask) * fq.NEG_INF).contiguous()
    sw, cw, fw = (
        {n: t.float() if t.dtype == torch.bfloat16 else t
         for n, t in w.items()} for w in _block_weights(g, D))
    return x, mem, key_bias, mask, sw, cw, fw


def _blocks32(x, mem, key_bias, sw, cw, fw):
    """(block, wrapper, plain, args, weights, kwargs) of B1-B6 at float32
    activations."""
    sk = dict(num_heads=HEADS, n_q=K)
    ck = dict(sk, n_kv=F)
    q = chip_smoke.quantized
    return [
        ("b1", fq.fused_self_attention_block,
         fq.fused_self_attention_block_plain, (x,), sw, sk),
        ("b1 one item", fq.fused_self_attention_block,
         fq.fused_self_attention_block_plain, (x[:1].contiguous(),), sw, sk),
        ("b2", fq.fused_cross_attention_block,
         fq.fused_cross_attention_block_plain, (x, mem, key_bias), cw, ck),
        ("b3", fq.fused_ffn_block, fq.fused_ffn_block_plain, (x,), fw, {}),
        ("b4", pq.fused_self_attention_block_q,
         pq.fused_self_attention_block_q_plain, (x,), q(sw), sk),
        ("b5", pq.fused_cross_attention_block_q,
         pq.fused_cross_attention_block_q_plain, (x, mem, key_bias), q(cw),
         ck),
        ("b6", pq.fused_ffn_block_q, pq.fused_ffn_block_q_plain, (x,), q(fw),
         {}),
    ]


@pytest.mark.parametrize("items", [1001, 1024])
def test_fp32_blocks_match_plain(hopper, items):
    """B1-B3 at float32 within 1e-5 of max|ref|; B4-B6 at float32
    activations within the int8 blocks' gate; float32 out, one counted
    launch a call, repeats bit for bit."""
    x, mem, key_bias, _, sw, cw, fw = _inputs32(hopper, items)
    for name, kern, plain, args, w, kw in _blocks32(x, mem, key_bias, sw, cw,
                                                    fw):
        before = kern.launches
        out = kern(*args, **w, **kw)
        torch.cuda.synchronize()
        assert kern.launches == before + 1, name
        assert out.dtype == torch.float32 and out.shape == args[0].shape
        ref = plain(*args, **w, **kw)
        if name.startswith(("b1", "b2", "b3")):
            _check_kernel(name, out, ref)
        else:
            a, b = out.reshape(-1, D), ref.reshape(-1, D)
            assert bool(torch.isfinite(a).all()), name
            assert (a - b).abs().max().item() <= BLOCK_ATOL, name
            assert torch.nn.functional.cosine_similarity(
                a, b, dim=-1).min().item() >= BLOCK_COS, name
        assert torch.equal(out, kern(*args, **w, **kw)), name


def test_b6_fp32_quantizes_x_from_its_fp32_values(hopper):
    """B6's kernel at float32 x writes the codes of the plain row_quant of
    the float32 x, bit for bit (not those of x cast to bf16)."""
    x, mem, key_bias, _, sw, cw, fw = _inputs32(hopper, 256)
    codes = chip_smoke.b6_codes(x, chip_smoke.quantized(fw))
    want = pq.row_quant(x)[0].reshape(codes.shape)
    assert torch.equal(codes, want)
    assert not torch.equal(codes, pq.row_quant(x.bfloat16())[0].reshape(
        codes.shape))


@pytest.mark.parametrize("items", [509, 512])
def test_b12_fp32_matches_plain_and_repeats_bit_for_bit(hopper, items):
    """B12s and B12c at float32, forward and backward: every output within
    1e-5 of max|ref| (a row near zero, such as dq of an item with no field,
    held to its tensor's scale), repeats bit for bit."""
    from unirec_tpu_torch.ops import fused_qformer_vjp as fv

    x, mem, kb, w, b, dout, _ = _b12_inputs(hopper, items)
    x, mem, dout = x.float(), mem.float(), dout.float()
    w = {n: t.float() for n, t in w.items()}
    b = {n: t.float() for n, t in b.items()}
    zero = torch.zeros(x.shape[0], device="cuda")
    sk = dict(num_heads=16, n_q=32)
    ck = dict(sk, n_kv=14)
    sa = (x, zero, w["wqkv"], b["bqkv"], w["wo"], b["bo"])
    ca = (x, mem, kb, w["wq"], b["bq"], w["wkv"], b["bkv"], w["wo"], b["bo"])
    s_out = fv.self_attention_fwd(*sa, **sk)
    c_out = fv.cross_attention_fwd(*ca, **ck)
    runs = [
        (lambda: fv.self_attention_fwd(*sa, **sk),
         lambda: fv.self_attention_fwd_plain(*sa, **sk)),
        (lambda: (fv.self_attention_bwd(s_out[1], w["wo"], zero, dout, **sk),),
         lambda: (fv.self_attention_bwd_plain(s_out[1], w["wo"], zero, dout,
                                              **sk),)),
        (lambda: fv.cross_attention_fwd(*ca, **ck),
         lambda: fv.cross_attention_fwd_plain(*ca, **ck)),
        (lambda: fv.cross_attention_bwd(c_out[1], c_out[2], w["wo"], kb,
                                        dout, **ck),
         lambda: fv.cross_attention_bwd_plain(c_out[1], c_out[2], w["wo"], kb,
                                              dout, **ck)),
    ]
    for i, (kern, plain) in enumerate(runs):
        got = kern()
        torch.cuda.synchronize()
        for j, (g, r) in enumerate(zip(got, plain())):
            assert g.dtype == torch.float32
            _check_kernel(f"run {i} output {j}", g, r)
        assert all(torch.equal(a, c) for a, c in zip(got, kern()))


def test_b12_fp32_autograd_gradients_match_plain(hopper):
    """The differentiable blocks at float32 on the card against the same
    Functions on the plain versions (the CPU path), every input's
    gradient within 1e-5 of max|ref|; one launch of each kernel."""
    from unirec_tpu_torch.ops import fused_qformer_vjp as fv

    x, mem, kb, w, b, dout, _ = _b12_inputs(hopper, 64)
    d = x.shape[1]
    leaves = [t.float().clone().requires_grad_() for t in (
        x.reshape(64, 32, d), mem.reshape(64, 14, d), w["wq"], b["bq"],
        w["wkv"], b["bkv"], w["wo"], b["bo"])]
    before = (fv.cross_attention_fwd.launches, fv.cross_attention_bwd.launches)
    out = fv.fused_cross_attention_train(leaves[0], leaves[1],
                                         kb.reshape(64, 14), *leaves[2:],
                                         num_heads=16)
    out.backward(dout.float().reshape(out.shape))
    assert (fv.cross_attention_fwd.launches,
            fv.cross_attention_bwd.launches) == (before[0] + 1, before[1] + 1)
    cpu = [t.detach().cpu().requires_grad_() for t in leaves]
    ref = fv.fused_cross_attention_train(cpu[0], cpu[1],
                                         kb.reshape(64, 14).cpu(), *cpu[2:],
                                         num_heads=16)
    ref.backward(dout.float().reshape(out.shape).cpu())
    _check_kernel("out", out.detach(), ref.detach().cuda())
    for i, (g, r) in enumerate(zip(leaves, cpu)):
        _check_kernel(f"grad {i}", g.grad, r.grad.cuda())
