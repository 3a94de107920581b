"""The 3xTF32 split that the float32 flash kernels use on tensor cores
(``csrc/ptx_helpers.cuh``: ``split_tf32``, ``mma_3xtf32``;
``csrc/flash_chunked_cluster.cuh``: ``chunk_fwd_cl32``,
``chunk_bwd_rows_cl32`` above head dim 256; ``csrc/flash_tf32.cu``:
``fwd_tf32``, ``bwd_rows_tf32``, ``bwd_keys_tf32`` up to 256), modelled in
torch on the CPU.

The tensor cores read the top 19 bits of each 32-bit operand (TF32: 10
mantissa bits).  The kernels hold each float32 operand x as big = rna(x) and
small = rna(x - big), rna rounding the float32 bit pattern to 10 mantissa
bits, to nearest with ties away from zero, and issue a product as small .
big + big . small + big . big.  The model does the same: products of tf32
values are exact in float32, summed in float32.  On seeded numpy inputs, B14's
forward (o, m, l) and backward (dq, dk, dv) with every score and value
product in 3xTF32 stay within 1e-5 of max|ref| of the float32 plain versions
(``ops/flash_vjp``) at head dims 16, 64, 128, 256, 512 and 1024, and B7b's
causal GQA backward (dq, dk, dv over right-padded rows) within 1e-5 of
``ops/flash_causal``'s at 64 and 128, the kernels' gate; with plain TF32
(big alone) they do not, which is why the split is there.
"""

import numpy as np
import pytest
import torch

from unirec_tpu_torch.ops import flash_causal as fc
from unirec_tpu_torch.ops import flash_vjp as fl
from unirec_tpu_torch.ops.attention import sm_scale

GATE = 1e-5  # max|d| / max|ref| of the float32 kernels (PERF.md section 2)
LOW13 = -8192  # 0xFFFFE000 as an int32: clears the 13 bits TF32 drops


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """x rounded to tf32 as ``cvt.rna.tf32.f32``: half of the dropped ulp
    added to the magnitude (the bit pattern's low 31 bits), then the 13 low
    bits cleared; NaN and infinity as they are."""
    u = x.contiguous().view(torch.int32)
    finite = (u & 0x7F800000) != 0x7F800000
    return (torch.where(finite, u + 0x1000, u) & LOW13).view(torch.float32)


def operand(x: torch.Tensor) -> torch.Tensor:
    """What the tensor cores read of a 32-bit operand: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & LOW13).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    (ab, as_), (bb, bs) = split(a), split(b)
    ab, as_, bb, bs = map(operand, (ab, as_, bb, bs))
    return torch.matmul(as_, bb) + torch.matmul(ab, bs) + torch.matmul(ab, bb)


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(operand(tf32_rna(a)), operand(tf32_rna(b)))


def b14_forward(mm, q, k, v, bias32):
    """B14p's forward (per-head q, k, v) with its products through ``mm``:
    (o, m, l) as ``flash_vjp.flash_cross_vjp_fwd_plain`` returns them."""
    s = mm(q, k.transpose(-1, -2)) * sm_scale(q.shape[-1])
    s = s + bias32[:, None, None, :]
    m = torch.clamp_min(s.amax(-1, keepdim=True), -1e9)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = mm(p, v) / torch.where(l == 0, 1.0, l)
    return o, fl._rows(m), fl._rows(l)


def b14_backward(mm, q, k, v, bias32, do, m, l, dsum):
    """B14p's backward with its products through ``mm``: (dq, dk, dv)."""
    s = mm(q, k.transpose(-1, -2)) * sm_scale(q.shape[-1])
    s = s + bias32[:, None, None, :]
    m_h, l_h = m.transpose(1, 2)[..., None], l.transpose(1, 2)[..., None]
    p = torch.exp(s - m_h) / torch.where(l_h == 0, 1.0, l_h)
    dp = mm(do, v.transpose(-1, -2))
    ds = p * (dp - dsum.transpose(1, 2)[..., None]) * sm_scale(q.shape[-1])
    return (mm(ds, k), mm(ds.transpose(-1, -2), q),
            mm(p.transpose(-1, -2), do))


def _inputs(hd: int, seed: int = 0):
    """Per-head q, k, v, dO (B 2, H 1, 16 queries over 200 keys), ~15% of
    the keys masked: the kernels' float32 inputs at a small size."""
    rng = np.random.default_rng(seed + hd)
    b, h, lq, lkv = 2, 1, 16, 200
    q, do = (torch.from_numpy(rng.standard_normal((b, h, lq, hd))
                              .astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, h, lkv, hd))
                             .astype(np.float32)) for _ in range(2))
    mask = torch.from_numpy((rng.random((b, lkv)) > 0.15).astype(np.float32))
    return q, k, v, do, ((1.0 - mask) * -1e9).contiguous()


def _rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    return ((got - ref).abs().max() / ref.abs().max()).item()


def test_rna_rounds_to_nearest_ties_away_from_zero():
    """1 + 2^-11 lies halfway between two tf32 values: rna takes the one
    away from zero, at either sign; below and above the tie it rounds to
    the nearer; the low 13 bits come out 0; infinity stays."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23,
                      1 + 0.75 * ulp, float("inf")], dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + ulp, float("inf")])
    got = tf32_rna(x)
    assert torch.equal(got, want)
    assert bool(((got[:4].view(torch.int32) & 0x1FFF) == 0).all())


def test_split_holds_each_operand_to_2e22():
    """big + small holds x to about 2^-22 of |x| (big alone to 2^-11): the
    error of each operand of a 3xTF32 product."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(100_000).astype(np.float32))
    big, small = split(x)
    assert torch.equal(operand(big), big) and torch.equal(operand(small),
                                                          small)
    assert ((big.double() + small.double() - x.double()).abs()
            <= 2.0 ** -22 * x.double().abs()).all()
    assert ((big.double() - x.double()).abs()
            <= 2.0 ** -11 * x.double().abs()).all()
    assert ((big.double() - x.double()).abs()
            > 2.0 ** -14 * x.double().abs()).any()


@pytest.mark.parametrize("hd", [16, 64, 128, 256, 512, 1024])
def test_3xtf32_holds_b14_forward(hd):
    """o, m and l with S = Q K^T and O = P V in 3xTF32 within 1e-5 of the
    float32 plain version; with plain TF32 o misses that gate."""
    q, k, v, _, bias32 = _inputs(hd)
    ref = fl.flash_cross_vjp_fwd_plain(q, k, v, bias32)
    got = b14_forward(mm_3xtf32, q, k, v, bias32)
    errs = [_rel(g, r) for g, r in zip(got, ref)]
    assert max(errs) <= GATE, errs
    plain = b14_forward(mm_tf32, q, k, v, bias32)
    assert _rel(plain[0], ref[0]) > 10 * GATE


@pytest.mark.parametrize("hd", [16, 64, 128, 256, 512, 1024])
def test_3xtf32_holds_b14_backward(hd):
    """dq, dk and dv with S, dP = dO V^T, dq = ds K, dk = ds^T Q and dv =
    p^T dO in 3xTF32 within 1e-5 of the float32 plain version (from the
    plain forward's m, l and dsum, as the kernels take them from theirs);
    with plain TF32 each misses that gate."""
    q, k, v, do, bias32 = _inputs(hd, seed=7)
    o, m, l = fl.flash_cross_vjp_fwd_plain(q, k, v, bias32)
    dsum = (do * o).sum(-1).transpose(1, 2).contiguous()
    ref = fl.flash_cross_vjp_bwd_plain(q, k, v, bias32, do, m, l, dsum)
    got = b14_backward(mm_3xtf32, q, k, v, bias32, do, m, l, dsum)
    errs = [_rel(g, r) for g, r in zip(got, ref)]
    assert max(errs) <= GATE, errs
    plain = b14_backward(mm_tf32, q, k, v, bias32, do, m, l, dsum)
    assert min(_rel(g, r) for g, r in zip(plain, ref)) > 10 * GATE


def b7b_backward(mm, q, k, v, pad_mask, do, m, l, dsum, hq, hkv):
    """B7b's causal GQA backward (merged heads, right-padded keys) with its
    products through ``mm``: (dq, dk, dv) as
    ``flash_causal.flash_causal_attention_bwd_plain`` returns them, dk and
    dv summed over each group's query heads."""
    b, seq, width = q.shape
    hd, groups = width // hq, hq // hkv
    qh, kh, vh, _ = fc._split(q, k, v, hq, hkv)
    doh = do.reshape(b, seq, hq, hd).transpose(1, 2)
    causal = torch.tril(torch.ones(seq, seq))[None, None]
    allowed = causal * pad_mask[:, None, None, :]
    s = mm(qh, kh.transpose(-1, -2)) * sm_scale(hd)
    s = s + (1.0 - allowed) * -1e9
    m_h, l_h = m.transpose(1, 2)[..., None], l.transpose(1, 2)[..., None]
    p = torch.exp(s - m_h) / torch.where(l_h == 0, 1.0, l_h)
    dp = mm(doh, vh.transpose(-1, -2))
    ds = p * (dp - dsum.transpose(1, 2)[..., None]) * sm_scale(hd)

    def kv_grad(g):
        g = g.reshape(b, hkv, groups, seq, hd).sum(2)
        return g.transpose(1, 2).reshape(b, seq, hkv * hd)

    dq = mm(ds, kh).transpose(1, 2).reshape(b, seq, width)
    return (dq, kv_grad(mm(ds.transpose(-1, -2), qh)),
            kv_grad(mm(p.transpose(-1, -2), doh)))


@pytest.mark.parametrize("hd", [64, 128])
def test_3xtf32_holds_b7b_backward(hd):
    """B7b's dq, dk and dv (B 2, L 96, 4 query heads over 2 key heads,
    rows right-padded to 96 and 53 keys) with S, dP, dq, dk and dv in
    3xTF32 within 1e-5 of the float32 plain version (from K1's plain m, l
    and dsum); with plain TF32 each misses that gate."""
    rng = np.random.default_rng(11 + hd)
    b, seq, hq, hkv = 2, 96, 4, 2
    q, do = (torch.from_numpy(rng.standard_normal((b, seq, hq * hd))
                              .astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, seq, hkv * hd))
                             .astype(np.float32)) for _ in range(2))
    pad_mask = (torch.arange(seq)[None] < torch.tensor([[seq], [53]])).float()
    o, m, l = fc.flash_causal_attention_fwd_plain(q, k, v, pad_mask, hq, hkv)
    dsum = fc.attention_dsum(do, o, hq).contiguous()
    ref = fc.flash_causal_attention_bwd_plain(q, k, v, pad_mask, do, m, l,
                                              dsum, hq, hkv)
    got = b7b_backward(mm_3xtf32, q, k, v, pad_mask, do, m, l, dsum, hq, hkv)
    errs = [_rel(g, r) for g, r in zip(got, ref)]
    assert max(errs) <= GATE, errs
    plain = b7b_backward(mm_tf32, q, k, v, pad_mask, do, m, l, dsum, hq, hkv)
    assert min(_rel(g, r) for g, r in zip(plain, ref)) > 10 * GATE
