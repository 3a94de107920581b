"""Run the sweep's block kernels and the packed item attention in the CPU
emulation of CUDA and hold them to their plain versions (no timing):

* the int8 TMA + wgmma GEMM of ``csrc/gemm_wide.cuh`` in each of its
  epilogues (``unirec_gemm_q_test``) against its plain form
  (``chip_smoke.gemm_q_plain``: the exact product, then the same fp32
  roundings), bit for bit (``torch.equal``), the SwiGLU epilogue's h and
  row maxima with the plain form's exp taken from the C library's ``expf``,
  the function the emulated kernel calls;
* B8 (``unirec_int8_linear``) against its plain version bit for bit, and
  B9b (``unirec_qwen3_swiglu_q``) within the block tolerance, its codes and
  row scales of h equal to ``kernel_row_quant`` of its own h and its output
  to the down product of those codes, at a gate|up tile whose gate box
  runs past the intermediate width;
* B4, B5 and B6 (``csrc/qformer_blocks.cu``) on the TMA path and on the edge
  path (a width that is not a multiple of 16 codes), B6 with one chunk and
  with chunks that end inside a k-tile, at bfloat16 and float32 activations
  (x's codes at float32 those of ``row_quant`` bit for bit);
* the residual product with its LayerNorm (``unirec_gemm_ln_test``): one
  launch of ``WG_BIAS_RESID_LN`` over a thread-block cluster (partial sums
  through the peers' shared memory) against ``WG_BIAS_RESID`` and
  ``layer_norm_kernel``, within bf16 rounding, at clusters of 1, 4 and 5
  CTAs whose last tile is ragged, and refused above 2048 columns;
* B1, B2 and B3 on the TMA kernel with the cluster LayerNorm (one CTA, and
  two whose second is 128 columns wide; no fp32 scratch) and at a width
  that is not a multiple of 8 (every product on ``gemm_wide.cuh``'s edge
  kernel, the two-pass LayerNorm);
* B15 (``csrc/packed_attention.cu``) in bf16 (the attention core's IA_B15
  rounding on B15's strides) and float32 (the scalar kernel), at head dims
  above 128, K = 128 over 512 keys, K = 2 over 600 keys, ~15% masked keys
  and an item with none.

    python3 scripts/emulate_cuda/check_sweep_blocks.py

Outputs are held as ``chip_smoke.py`` holds them: blocks max|d| <= 5e-2 and
per-row cosine >= 0.9999; B15 max|d| / max|ref| <= 1e-5 (float32) or 2e-2
with per-row cosine >= 0.9999 (bf16), the item without a key to its values'
mean; every kernel repeats bit for bit.  The sources build with ``g++`` as
``check_attention.py`` builds them (about a minute), the cases take a few
minutes.
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(HERE))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from check_attention import _Entries, build  # noqa: E402
from unirec_tpu_torch.ops import _build  # noqa: E402
from unirec_tpu_torch.ops import attention as pa  # noqa: E402
from unirec_tpu_torch.ops import fused_qformer_int8 as pq  # noqa: E402
from unirec_tpu_torch.ops import fused_qformer_layer as fq  # noqa: E402
from unirec_tpu_torch.ops import fused_qwen3_int8 as pf  # noqa: E402
from unirec_tpu_torch.ops import packed_attention as pp  # noqa: E402
from unirec_tpu_torch.ops.int8_matmul import (  # noqa: E402
    int8_linear_plain,
    kernel_row_quant,
)

BLOCK_ATOL, BLOCK_COS = 5e-2, 0.9999
KERNEL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
_LIBM = ctypes.CDLL("libm.so.6")
_LIBM.expf.restype = ctypes.c_float
_LIBM.expf.argtypes = [ctypes.c_float]


def _expf(x: torch.Tensor) -> torch.Tensor:
    """The C library's expf elementwise (torch's CPU exp can differ from it
    by an ulp)."""
    return torch.tensor([_LIBM.expf(v) for v in x.flatten().tolist()],
                        dtype=torch.float32).reshape(x.shape)


def _emulated():
    raw = build(ROOT / "unirec_tpu_torch" / "csrc",
                ROOT / "build" / "emulate_cuda" / "sweep",
                ("qformer_blocks.cu", "packed_attention.cu"))
    return raw, _build.bind(_Entries(raw))


def _run(raw, call, *tensors):
    raw.emu_clear()
    for t in tensors:
        raw.emu_register(t.data_ptr(), t.untyped_storage().nbytes())
    err = call()
    fault = raw.emu_fault()
    if fault:
        raise AssertionError(fault.decode())
    if err:
        raise AssertionError(f"C entry returned {err}")


def _twice(raw, call, outs, *tensors):
    """call() twice; the second run must repeat the first's bits."""
    _run(raw, call, *tensors, *outs)
    first = [t.clone() for t in outs]
    _run(raw, call, *tensors, *outs)
    if not all(torch.equal(a, b) for a, b in zip(first, outs)):
        raise AssertionError("a repeat gave other bits")


def _p(t):
    return None if t is None else t.data_ptr()


def _hold_block(name, out, ref):
    a = out.float().reshape(-1, out.shape[-1])
    b = ref.float().reshape(-1, ref.shape[-1])
    err = (a - b).abs().max().item()
    cos = torch.nn.functional.cosine_similarity(a, b, dim=-1).min().item()
    if not (bool(torch.isfinite(a).all()) and err <= BLOCK_ATOL
            and cos >= BLOCK_COS):
        raise AssertionError(f"{name}: max|d| {err:.2e}, min cosine {cos:.6f}")
    print(f"{name}: max|d| {err:.1e}, min row cosine {cos:.7f}, repeats bit "
          "for bit", flush=True)


def _bf(gen, *shape, std=1.0):
    return (torch.randn(*shape, generator=gen) * std).bfloat16()


def _vec(gen, n, mean=0.0):
    return mean + 0.1 * torch.randn(n, generator=gen)


def check_gemm_q(lib, raw, m, n, k, epi, chunk):
    """The int8 GEMM in one epilogue against its plain form, bit for bit
    (swiglu: n columns of h from w [2n, k], and its row maxima)."""
    gen = torch.Generator().manual_seed(m + n + k + chunk)
    wn = 2 * n if epi == "swiglu" else n
    a = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8)
    w = torch.randint(-127, 128, (wn, k), generator=gen, dtype=torch.int8)
    groups = k // chunk if epi.startswith("chunked") else 1
    rs = (torch.rand(m, groups, generator=gen) * 1e-3).contiguous()
    cs_ = (torch.rand(wn, generator=gen) * 1e-2).contiguous()
    bias = _vec(gen, n)
    resid = _bf(gen, m, n)
    dtype = torch.bfloat16 if epi in ("bias", "plain") else torch.float32
    c, mx = torch.zeros(m, n, dtype=dtype), torch.zeros(m)

    def call():
        mx.zero_()
        return lib.unirec_gemm_q_test(
            cs.GEMM_Q_EPIS.index(epi), a.data_ptr(), w.data_ptr(),
            rs.data_ptr(), groups, cs_.data_ptr(), bias.data_ptr(),
            resid.data_ptr(), c.data_ptr(), mx.data_ptr(), m, n, k, chunk,
            None)

    _twice(raw, call, [c, mx], a, w, rs, cs_, bias, resid)
    ref = cs.gemm_q_plain(epi, a, w, rs, cs_, bias, resid, chunk, exp=_expf)
    if epi == "swiglu":
        ok = torch.equal(c, ref[0]) and torch.equal(mx, ref[1])
    else:
        ok = torch.equal(c, ref)
    if not ok:
        got = c.float() - (ref[0] if epi == "swiglu" else ref).float()
        raise AssertionError(f"int8 GEMM {epi}: not its plain form's bits "
                             f"(max|d| {got.abs().max().item():.2e})")
    print(f"int8 GEMM {epi} M {m} N {n} K {k} chunk {chunk}: its plain "
          "form's bits, repeats bit for bit", flush=True)


def check_int8_linear(lib, raw, m, k, n):
    """B8 against its plain version, bit for bit."""
    gen = torch.Generator().manual_seed(m + k + n)
    x = _bf(gen, m, k)
    x[5] = 0.0
    wq, ws = pq.quantize_weight(torch.randn(n, k, generator=gen) * 0.03)
    out = torch.zeros(m, n).bfloat16()
    xq, xs = torch.zeros(m, k, dtype=torch.int8), torch.zeros(m)
    _twice(raw, lambda: lib.unirec_int8_linear(
        _p(x), _p(wq), _p(ws), _p(out), _p(xq), _p(xs), m, n, k, None),
        [out], x, wq, ws, xq, xs)
    if not torch.equal(out, int8_linear_plain(x, wq, ws)):
        raise AssertionError(f"B8 [{m}, {k}] -> {n}: not its plain bits")
    print(f"B8 [{m}, {k}] -> {n}: its plain version's bits, repeats bit for "
          "bit", flush=True)


def check_swiglu_block(lib, raw, rows, d, inter):
    """B9b within the block tolerance of its plain version, its codes and
    row scales of h those of kernel_row_quant(h) and its output the down
    product of those codes (``_mm_q``), bit for bit."""
    gen = torch.Generator().manual_seed(rows + d + inter)
    x = _bf(gen, rows, d)
    wgu, sgu = pq.quantize_weight(torch.randn(2 * inter, d, generator=gen)
                                  * 0.05)
    wd, sd = pq.quantize_weight(torch.randn(d, inter, generator=gen) * 0.05)
    out = torch.zeros(rows, d).bfloat16()
    xq, xs = torch.zeros(rows, d, dtype=torch.int8), torch.zeros(rows)
    h, hs = torch.zeros(rows, inter), torch.zeros(rows)
    hq = torch.zeros(rows, inter, dtype=torch.int8)
    _twice(raw, lambda: lib.unirec_qwen3_swiglu_q(
        _p(x), _p(wgu), _p(sgu), _p(wd), _p(sd), _p(out), _p(xq), _p(xs),
        _p(h), _p(hq), _p(hs), rows, d, inter, None),
        [out, h, hq, hs], x, wgu, sgu, wd, sd, xq, xs)
    codes, scales = kernel_row_quant(h)
    if not (torch.equal(hq, codes) and torch.equal(hs, scales[:, 0])
            and torch.equal(out, pq._mm_q(hq, hs[:, None], wd, sd).bfloat16())):
        raise AssertionError(f"B9b rows {rows}: h's codes, scales or the down "
                             "product are not their plain bits")
    _hold_block(f"B9b rows {rows} D {d} I {inter}", out,
                pf.swiglu_mlp_int8_plain(x, wgu, sgu, wd, sd))


def check_int8_blocks(lib, raw, items, nq, nkv, d, heads, inter, chunk,
                      dtype=torch.bfloat16):
    """B4-B6 at bfloat16 or float32 activations; at float32 x's int8 codes
    (B6's xq) must be ``row_quant`` of the float32 x bit for bit."""
    gen = torch.Generator().manual_seed(items + d + inter + chunk)
    rows = items * nq
    x = torch.randn(items, nq, d, generator=gen).to(dtype)
    mask = (torch.rand(items, nkv, generator=gen) > 0.15).float()
    mask[-1] = 0.0
    mem = (torch.randn(items, nkv, d, generator=gen) * mask[..., None]).to(
        dtype)
    code = pa.dtype_code(x)
    kb = ((1.0 - mask) * -1e9).contiguous()
    s = d ** -0.5
    q = {n: pq.quantize_weight(torch.randn(o, i, generator=gen) * s)
         for n, (o, i) in dict(wqkv=(3 * d, d), wo=(d, d), wq=(d, d),
                                wkv=(2 * d, d), w1=(inter, d),
                                w2=(d, inter)).items()}
    v = {n: _vec(gen, o) for n, o in dict(bqkv=3 * d, bo=d, bq=d, bkv=2 * d,
                                          b1=inter, b2=d).items()}
    g, b = _vec(gen, d, 1.0), _vec(gen, d)
    scale = fq._scale(d // heads, torch.bfloat16)
    out = torch.empty_like(x)
    xq, xs = torch.empty(rows, d, dtype=torch.int8), torch.empty(rows)
    where = f"{str(dtype)[6:]} items {items} K {nq} D {d} heads {heads}"
    if chunk == inter:  # B4, B5 once a width
        qkv = torch.empty(rows, 3 * d).bfloat16()
        ctx = torch.empty(rows, d).bfloat16()
        acc = torch.empty(rows, d)
        (wqkv, sqkv), (wo, so) = q["wqkv"], q["wo"]
        _twice(raw, lambda: lib.unirec_qformer_self_block_q(
            _p(x), _p(wqkv), _p(sqkv), _p(v["bqkv"]), _p(wo), _p(so),
            _p(v["bo"]), _p(g), _p(b), _p(out), _p(xq), _p(xs), _p(qkv),
            _p(ctx), _p(acc), items, nq, d, heads, code, scale, 1e-12, None),
            [out], x, wqkv, sqkv, v["bqkv"], wo, so, v["bo"], g, b, xq, xs,
            qkv, ctx, acc)
        _hold_block(f"B4 {where}", out, pq.fused_self_attention_block_q_plain(
            x, wqkv, sqkv, v["bqkv"], wo, so, v["bo"], g, b, num_heads=heads,
            n_q=nq))
        (wq, sq), (wkv, skv) = q["wq"], q["wkv"]
        mq, ms = torch.empty(items * nkv, d, dtype=torch.int8), torch.empty(
            items * nkv)
        qb, kv = torch.empty(rows, d).bfloat16(), torch.empty(
            items * nkv, 2 * d).bfloat16()
        _twice(raw, lambda: lib.unirec_qformer_cross_block_q(
            _p(x), _p(mem), _p(kb), _p(wq), _p(sq), _p(v["bq"]), _p(wkv),
            _p(skv), _p(v["bkv"]), _p(wo), _p(so), _p(v["bo"]), _p(g), _p(b),
            _p(out), _p(xq), _p(xs), _p(mq), _p(ms), _p(qb), _p(kv), _p(ctx),
            _p(acc), items, nq, nkv, d, d, heads, code, scale, 1e-12, None),
            [out], x, mem, kb, wq, sq, v["bq"], wkv, skv, v["bkv"], wo, so,
            v["bo"], g, b, xq, xs, mq, ms, qb, kv, ctx, acc)
        _hold_block(f"B5 {where} F {nkv}", out,
                    pq.fused_cross_attention_block_q_plain(
                        x, mem, kb, wq, sq, v["bq"], wkv, skv, v["bkv"], wo,
                        so, v["bo"], g, b, num_heads=heads, n_q=nq,
                        n_kv=nkv))
    (w1, s1), (w2, s2) = q["w1"], q["w2"]
    u = torch.empty(rows, inter)
    hq = torch.empty(rows, inter, dtype=torch.int8)
    hs = torch.empty(rows, inter // chunk)
    acc = torch.empty(rows, d)
    _twice(raw, lambda: lib.unirec_qformer_ffn_block_q(
        _p(x), _p(w1), _p(s1), _p(v["b1"]), _p(w2), _p(s2), _p(v["b2"]),
        _p(g), _p(b), _p(out), _p(xq), _p(xs), _p(u), _p(hq), _p(hs),
        _p(acc), rows, d, inter, chunk, code, 1e-12, None),
        [out], x, w1, s1, v["b1"], w2, s2, v["b2"], g, b, xq, xs, u, hq, hs,
        acc)
    if not torch.equal(xq, pq.row_quant(x)[0].reshape(rows, d)):
        raise AssertionError(f"B6 {where}: x's codes are not row_quant's")
    _hold_block(f"B6 {where} I {inter} chunk {chunk}", out,
                pq.fused_ffn_block_q_plain(x, w1, s1, v["b1"], w2, s2,
                                           v["b2"], g, b, chunk=chunk))


def check_gemm_ln(lib, raw, m, n, k):
    """The cluster LayerNorm epilogue against the two-pass route on the same
    inputs: the same fp32 sums up to the LayerNorm's own order, so within
    bf16 rounding of the unit-scale output (2 ulps at |y| < 8)."""
    gen = torch.Generator().manual_seed(m + n + k)
    a, w = _bf(gen, m, k), _bf(gen, n, k, std=k ** -0.5)
    bias, resid = _vec(gen, n), _bf(gen, m, n)
    g, b = _vec(gen, n, 1.0), _vec(gen, n)
    outs = [torch.zeros(m, n).bfloat16() for _ in range(2)]
    acc = torch.zeros(m, n)
    if n > 2048:  # more than a portable cluster: refused, two-pass only
        raw.emu_clear()
        if lib.unirec_gemm_ln_test(1, _p(a), _p(w), _p(bias), _p(resid),
                                   _p(g), _p(b), _p(outs[1]), None, m, n, k,
                                   1e-12, None) == 0:
            raise AssertionError(f"cluster LayerNorm took N {n} > 2048")
        which = (0,)
    else:
        which = (0, 1)
    for i in which:
        _twice(raw, lambda i=i: lib.unirec_gemm_ln_test(
            i, _p(a), _p(w), _p(bias), _p(resid), _p(g), _p(b), _p(outs[i]),
            _p(acc) if i == 0 else None, m, n, k, 1e-12, None), [outs[i]],
            a, w, bias, resid, g, b, acc)
    ref = fq._layer_norm_rows(a.float() @ w.float().t() + bias
                              + resid.float(), g, b, 1e-12)
    for i in which:
        err = (outs[i].float() - ref).abs().max().item()
        if not err <= 2 * 2 ** -5:
            raise AssertionError(f"LayerNorm GEMM route {i}: max|d| {err:.2e}")
    if len(which) == 2:
        d = (outs[0].float() - outs[1].float()).abs().max().item()
        if not d <= 2 * 2 ** -5:
            raise AssertionError(f"cluster LayerNorm vs two passes: {d:.2e}")
    print(f"residual GEMM + LayerNorm M {m} N {n} K {k}: "
          f"{'cluster of ' + str(-(-n // 256)) if len(which) == 2 else 'two passes only'}"
          ", within bf16 rounding of the fp32 reference, repeats bit for bit",
          flush=True)


def check_bf16_blocks(lib, raw, items, nq, nkv, d, heads, inter):
    gen = torch.Generator().manual_seed(items + d + inter)
    rows = items * nq
    x = _bf(gen, items, nq, d)
    mask = (torch.rand(items, nkv, generator=gen) > 0.15).float()
    mask[-1] = 0.0
    mem = _bf(gen, items, nkv, d) * mask[..., None].bfloat16()
    kb = ((1.0 - mask) * -1e9).contiguous()
    s = d ** -0.5
    w = {n: _bf(gen, o, i, std=s) for n, (o, i) in dict(
        wqkv=(3 * d, d), wo=(d, d), wq=(d, d), wkv=(2 * d, d), w1=(inter, d),
        w2=(d, inter)).items()}
    v = {n: _vec(gen, o) for n, o in dict(bqkv=3 * d, bo=d, bq=d, bkv=2 * d,
                                          b1=inter, b2=d).items()}
    g, b = _vec(gen, d, 1.0), _vec(gen, d)
    scale = fq._scale(d // heads, torch.bfloat16)
    out = torch.empty_like(x)
    qkv = torch.empty(rows, 3 * d).bfloat16()
    ctx = torch.empty(rows, d).bfloat16()
    # the fp32 scratch only where the wrappers give it (the two-pass route)
    acc = torch.empty(rows, d) if lib.unirec_resid_ln_two_pass(d, d) else None
    acc3 = (torch.empty(rows, d) if lib.unirec_resid_ln_two_pass(d, inter)
            else None)
    where = (f"items {items} K {nq} D {d} heads {heads}, "
             f"{'two-pass' if acc is not None else 'cluster'} LayerNorm")
    _twice(raw, lambda: lib.unirec_qformer_self_block(
        _p(x), _p(w["wqkv"]), _p(v["bqkv"]), _p(w["wo"]), _p(v["bo"]), _p(g),
        _p(b), _p(out), _p(qkv), _p(ctx), _p(acc), items, nq, d, heads, scale,
        1e-12, None), [out], x, w["wqkv"], v["bqkv"], w["wo"], v["bo"], g, b,
        qkv, ctx, *[t for t in (acc,) if t is not None])
    _hold_block(f"B1 {where}", out, fq.fused_self_attention_block_plain(
        x, w["wqkv"], v["bqkv"], w["wo"], v["bo"], g, b, num_heads=heads,
        n_q=nq))
    qb, kv = torch.empty(rows, d).bfloat16(), torch.empty(
        items * nkv, 2 * d).bfloat16()
    _twice(raw, lambda: lib.unirec_qformer_cross_block(
        _p(x), _p(mem), _p(kb), _p(w["wq"]), _p(v["bq"]), _p(w["wkv"]),
        _p(v["bkv"]), _p(w["wo"]), _p(v["bo"]), _p(g), _p(b), _p(out), _p(qb),
        _p(kv), _p(ctx), _p(acc), items, nq, nkv, d, d, heads, scale, 1e-12,
        None), [out], x, mem, kb, w["wq"], v["bq"], w["wkv"], v["bkv"],
        w["wo"], v["bo"], g, b, qb, kv, ctx,
        *[t for t in (acc,) if t is not None])
    _hold_block(f"B2 {where} F {nkv}", out,
                fq.fused_cross_attention_block_plain(
                    x, mem, kb, w["wq"], v["bq"], w["wkv"], v["bkv"], w["wo"],
                    v["bo"], g, b, num_heads=heads, n_q=nq, n_kv=nkv))
    h = torch.empty(rows, inter).bfloat16()
    _twice(raw, lambda: lib.unirec_qformer_ffn_block(
        _p(x), _p(w["w1"]), _p(v["b1"]), _p(w["w2"]), _p(v["b2"]), _p(g),
        _p(b), _p(out), _p(h), _p(acc3), rows, d, inter, 1e-12, None), [out],
        x, w["w1"], v["b1"], w["w2"], v["b2"], g, b, h,
        *[t for t in (acc3,) if t is not None])
    _hold_block(f"B3 {where} I {inter}", out, fq.fused_ffn_block_plain(
        x, w["w1"], v["b1"], w["w2"], v["b2"], g, b))


def check_b15(lib, raw, dtype, items, heads, nq, nkv, hd, merged):
    gen = torch.Generator().manual_seed(items * 7 + nq + nkv + hd)

    def rand(n):
        if merged:  # per-head views of [items, L, heads * hd]
            return (torch.randn(items, n, heads, hd, generator=gen)
                    .to(dtype).transpose(1, 2))
        return torch.randn(items, heads, n, hd, generator=gen).to(dtype)

    q, k, v = rand(nq), rand(nkv), rand(nkv)
    mask = (torch.rand(items, nkv, generator=gen) > 0.15).float()
    mask[items // 2] = 0.0
    bias = ((1.0 - mask) * -1e9)[:, None, None, :]
    bias32 = pa.key_bias(bias, items, nkv, q.device)
    out = torch.empty(items, heads, nq, hd, dtype=dtype)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    _twice(raw, lambda: lib.unirec_packed_item_attention(
        _p(q), _p(k), _p(v), _p(bias32), _p(out), *strides, items, heads, nq,
        nkv, hd, pa.dtype_code(q), pa.sm_scale(hd), None),
        [out], q, k, v, bias32)
    ref = pp.packed_item_attention_plain(q, k, v, bias)
    a, r = out.float().reshape(-1, hd), ref.float().reshape(-1, hd)
    rel = ((a - r).abs().max() / r.abs().max()).item()
    cos = torch.nn.functional.cosine_similarity(a, r, dim=-1).min().item()
    mean = v[items // 2].float().mean(1, keepdim=True).expand(heads, nq, hd)
    none = ((out[items // 2].float() - mean).abs().max() / mean.abs().max()
            ).item()
    tol = KERNEL_TOL[dtype]
    if not (rel <= tol and none <= tol and
            (dtype == torch.float32 or cos >= 0.9999)):
        raise AssertionError(f"B15: rel {rel:.2e}, cosine {cos:.6f}, the item "
                             f"without keys {none:.2e}")
    print(f"B15 {str(dtype)[6:]} items {items} heads {heads} K {nq} F {nkv} "
          f"hd {hd} {'merged' if merged else 'contiguous'}: max rel "
          f"{rel:.1e}, min row cosine {cos:.7f}, repeats bit for bit",
          flush=True)


def main() -> int:
    raw, lib = _emulated()
    for case in ((150, 320, 384, "bias", 384),
                 (150, 320, 384, "bias_f32", 384),
                 (150, 320, 384, "bias_resid", 384),
                 (150, 320, 384, "chunked_resid", 384),
                 (150, 320, 384, "chunked_resid", 128),
                 (70, 128, 384, "chunked_resid", 192),
                 (150, 320, 384, "chunked", 128),
                 (150, 320, 384, "plain", 384),
                 (150, 104, 100, "plain", 100),  # the edge kernel
                 (150, 160, 256, "swiglu", 256),  # a gate box past I
                 (70, 256, 128, "swiglu", 128)):
        check_gemm_q(lib, raw, *case)
    for case in ((150, 128, 320), (70, 256, 48)):
        check_int8_linear(lib, raw, *case)
    for case in ((150, 128, 160), (129, 256, 384)):
        check_swiglu_block(lib, raw, *case)
    # the TMA path, one chunk and chunks that end inside a k-tile; the edge
    # path (100 and 104 codes are not whole 16-byte rows)
    check_int8_blocks(lib, raw, 3, 8, 6, 128, 2, 384, 384)
    check_int8_blocks(lib, raw, 3, 8, 6, 128, 2, 384, 192)
    check_int8_blocks(lib, raw, 3, 8, 6, 100, 4, 256, 256)
    check_int8_blocks(lib, raw, 2, 8, 6, 104, 4, 192, 64)
    check_int8_blocks(lib, raw, 3, 8, 6, 128, 2, 384, 192, torch.float32)
    check_int8_blocks(lib, raw, 2, 8, 6, 100, 4, 256, 256, torch.float32)
    for case in ((150, 128, 64), (150, 896, 64), (40, 1032, 64),
                 (40, 2304, 64)):
        check_gemm_ln(lib, raw, *case)
    check_bf16_blocks(lib, raw, 3, 8, 6, 128, 2, 256)
    check_bf16_blocks(lib, raw, 3, 8, 6, 384, 4, 256)
    check_bf16_blocks(lib, raw, 3, 8, 6, 100, 4, 200)
    for dtype in (torch.bfloat16, torch.float32):
        check_b15(lib, raw, dtype, 5, 2, 32, 14, 64, True)
        check_b15(lib, raw, dtype, 3, 2, 32, 32, 64, False)
        check_b15(lib, raw, dtype, 3, 1, 8, 14, 200, False)
        check_b15(lib, raw, dtype, 2, 1, 4, 6, 512, True)
        check_b15(lib, raw, dtype, 2, 1, 128, 512, 64, False)
        check_b15(lib, raw, dtype, 3, 1, 2, 600, 32, True)
        check_b15(lib, raw, dtype, 3, 2, 16, 14, 24, False)
    print("all emulated sweep kernels agree with their plain versions")
    return 0


if __name__ == "__main__":
    sys.exit(main())
