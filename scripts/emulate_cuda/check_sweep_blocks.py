"""Run the sweep's block kernels and the packed item attention in the CPU
emulation of CUDA and hold them to their plain versions (no timing):

* the int8 TMA + wgmma GEMM of ``csrc/gemm_wide.cuh`` against
  ``gemm_s8_kernel`` (``unirec_gemm_q_test``) on the same codes, for each
  epilogue they share and B6's up projection with its gelu and
  quantization (h's codes and scales), bit for bit (``torch.equal``);
* B4, B5 and B6 (``csrc/qformer_blocks.cu``) on the TMA path and on the edge
  path (a width that is not a multiple of 16 codes), B6 with one chunk and
  with chunks that end inside a k-tile;
* B1, B2 and B3 at a width that is not a multiple of 8 (their products on
  ``gemm_wide.cuh``'s edge kernel with the gelu and residual epilogues);
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

from check_attention import _Entries, build  # noqa: E402
from unirec_tpu_torch.ops import _build  # noqa: E402
from unirec_tpu_torch.ops import attention as pa  # noqa: E402
from unirec_tpu_torch.ops import fused_qformer_int8 as pq  # noqa: E402
from unirec_tpu_torch.ops import fused_qformer_layer as fq  # noqa: E402
from unirec_tpu_torch.ops import packed_attention as pp  # noqa: E402

BLOCK_ATOL, BLOCK_COS = 5e-2, 0.9999
KERNEL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
EPIS = ("bias", "up_gelu_quant", "bias_resid", "chunked_resid")


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
    """The new int8 GEMM against gemm_s8_kernel on the same codes, one step
    (an epilogue, or B6's up projection with its gelu and quantization)."""
    gen = torch.Generator().manual_seed(m + n + k + chunk)
    a = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=gen, dtype=torch.int8)
    groups = k // chunk if epi == "chunked_resid" else 1
    rs = (torch.rand(m, groups, generator=gen) * 1e-3).contiguous()
    cs = (torch.rand(n, generator=gen) * 1e-2).contiguous()
    bias = _vec(gen, n)
    resid = _bf(gen, m, n)
    out_dtype = {"bias": torch.bfloat16, "up_gelu_quant": torch.int8}.get(
        epi, torch.float32)
    got = [torch.zeros(m, n, dtype=out_dtype) for _ in range(2)]
    scratch = torch.zeros(m, n)
    scales = [torch.zeros(m, n // chunk) for _ in range(2)]
    for which in (0, 1):
        c, sc = got[which], scales[which]
        _twice(raw, lambda c=c, sc=sc, which=which: lib.unirec_gemm_q_test(
            which, EPIS.index(epi), a.data_ptr(), w.data_ptr(), rs.data_ptr(),
            groups, cs.data_ptr(), bias.data_ptr(), resid.data_ptr(),
            c.data_ptr(), scratch.data_ptr(), sc.data_ptr(), m, n, k, chunk,
            None), [c, sc], a, w, rs, cs, bias, resid, scratch)
    if not (torch.equal(got[0], got[1]) and torch.equal(scales[0], scales[1])):
        d = (got[0].float() - got[1].float()).abs().max().item()
        raise AssertionError(f"int8 GEMM {epi}: not gemm_s8_kernel's bits "
                             f"(max|d| {d:.2e})")
    print(f"int8 GEMM {epi} M {m} N {n} K {k} chunk {chunk}: "
          "gemm_s8_kernel's bits", flush=True)


def check_int8_blocks(lib, raw, items, nq, nkv, d, heads, inter, chunk):
    gen = torch.Generator().manual_seed(items + d + inter + chunk)
    rows = items * nq
    x = _bf(gen, items, nq, d)
    mask = (torch.rand(items, nkv, generator=gen) > 0.15).float()
    mask[-1] = 0.0
    mem = _bf(gen, items, nkv, d) * mask[..., None].bfloat16()
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
    where = f"items {items} K {nq} D {d} heads {heads}"
    if chunk == inter:  # B4, B5 once a width
        qkv = torch.empty(rows, 3 * d).bfloat16()
        ctx = torch.empty(rows, d).bfloat16()
        acc = torch.empty(rows, d)
        (wqkv, sqkv), (wo, so) = q["wqkv"], q["wo"]
        _twice(raw, lambda: lib.unirec_qformer_self_block_q(
            _p(x), _p(wqkv), _p(sqkv), _p(v["bqkv"]), _p(wo), _p(so),
            _p(v["bo"]), _p(g), _p(b), _p(out), _p(xq), _p(xs), _p(qkv),
            _p(ctx), _p(acc), items, nq, d, heads, scale, 1e-12, None),
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
            _p(acc), items, nq, nkv, d, d, heads, scale, 1e-12, None),
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
        _p(acc), rows, d, inter, chunk, 1e-12, None),
        [out], x, w1, s1, v["b1"], w2, s2, v["b2"], g, b, xq, xs, u, hq, hs,
        acc)
    _hold_block(f"B6 {where} I {inter} chunk {chunk}", out,
                pq.fused_ffn_block_q_plain(x, w1, s1, v["b1"], w2, s2,
                                           v["b2"], g, b, chunk=chunk))


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
    acc = torch.empty(rows, d)
    where = f"items {items} K {nq} D {d} heads {heads}"
    _twice(raw, lambda: lib.unirec_qformer_self_block(
        _p(x), _p(w["wqkv"]), _p(v["bqkv"]), _p(w["wo"]), _p(v["bo"]), _p(g),
        _p(b), _p(out), _p(qkv), _p(ctx), _p(acc), items, nq, d, heads, scale,
        1e-12, None), [out], x, w["wqkv"], v["bqkv"], w["wo"], v["bo"], g, b,
        qkv, ctx, acc)
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
        w["wo"], v["bo"], g, b, qb, kv, ctx, acc)
    _hold_block(f"B2 {where} F {nkv}", out,
                fq.fused_cross_attention_block_plain(
                    x, mem, kb, w["wq"], v["bq"], w["wkv"], v["bkv"], w["wo"],
                    v["bo"], g, b, num_heads=heads, n_q=nq, n_kv=nkv))
    h = torch.empty(rows, inter).bfloat16()
    _twice(raw, lambda: lib.unirec_qformer_ffn_block(
        _p(x), _p(w["w1"]), _p(v["b1"]), _p(w["w2"]), _p(v["b2"]), _p(g),
        _p(b), _p(out), _p(h), _p(acc), rows, d, inter, 1e-12, None), [out],
        x, w["w1"], v["b1"], w["w2"], v["b2"], g, b, h, acc)
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
                 (150, 320, 384, "up_gelu_quant", 320),
                 (150, 320, 384, "up_gelu_quant", 64),
                 (20, 4160, 64, "up_gelu_quant", 4160),  # a group above 4096
                 (150, 320, 384, "bias_resid", 384),
                 (150, 320, 384, "chunked_resid", 384),
                 (150, 320, 384, "chunked_resid", 128),
                 (70, 128, 384, "chunked_resid", 192)):
        check_gemm_q(lib, raw, *case)
    # the TMA path, one chunk and chunks that end inside a k-tile; the edge
    # path (100 and 104 codes are not whole 16-byte rows)
    check_int8_blocks(lib, raw, 3, 8, 6, 128, 2, 384, 384)
    check_int8_blocks(lib, raw, 3, 8, 6, 128, 2, 384, 192)
    check_int8_blocks(lib, raw, 3, 8, 6, 100, 4, 256, 256)
    check_int8_blocks(lib, raw, 2, 8, 6, 104, 4, 192, 64)
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
