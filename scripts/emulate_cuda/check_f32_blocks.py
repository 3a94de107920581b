"""Run the fp32 forms of the Item Q-Former blocks in the CPU emulation of
CUDA and hold them to their plain versions (no timing):

* B1, B2 and B3 at float32 (``unirec_qformer_*_block_f32`` of
  ``csrc/qformer_blocks.cu``: the fp32 GEMM of ``csrc/gemm_f32.cuh``, the
  scalar attention of ``csrc/attention_f32.cuh`` and the fp32 LayerNorm),
  with ragged GEMM edges, ~15% masked fields and an item with none;
* B12s and B12c at float32, forward and backward
  (``unirec_b12_*_f32`` of ``csrc/fused_qformer_vjp.cu``), at head dims
  below and above one 64-column chunk and at K and F above one 64-row tile.

    python3 scripts/emulate_cuda/check_f32_blocks.py

Every output is held to max|d| / max|ref| <= 1e-5 over the whole tensor
(the fp32 gate of ``chip_smoke.py``; by C-11's rule a row whose reference is
near zero, such as the gradients of an item with no valid field, is held to
the tensor's scale, not its own) and must repeat bit for bit.
The sources build with ``g++`` as ``check_attention.py`` builds them.
"""

from __future__ import annotations

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(HERE))

import torch  # noqa: E402

from check_attention import _Entries, build  # noqa: E402
from check_sweep_blocks import _p, _twice  # noqa: E402
from unirec_tpu_torch.ops import _build  # noqa: E402
from unirec_tpu_torch.ops import fused_qformer_layer as fq  # noqa: E402
from unirec_tpu_torch.ops import fused_qformer_vjp as fv  # noqa: E402

TOL = 1e-5


def _emulated():
    raw = build(ROOT / "unirec_tpu_torch" / "csrc",
                ROOT / "build" / "emulate_cuda" / "f32",
                ("qformer_blocks.cu", "fused_qformer_vjp.cu"))
    return raw, _build.bind(_Entries(raw))


def _hold(name, out, ref):
    rel = ((out - ref).abs().max() / ref.abs().max()).item()
    if not (bool(torch.isfinite(out).all()) and rel <= TOL):
        raise AssertionError(f"{name}: max|d|/max|ref| {rel:.2e}")
    print(f"{name}: max|d|/max|ref| {rel:.1e}, repeats bit for bit",
          flush=True)


def _inputs(seed, items, nq, nkv, d, inter):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(items, nq, d, generator=gen)
    mask = (torch.rand(items, nkv, generator=gen) > 0.15).float()
    mask[-1] = 0.0
    mem = torch.randn(items, nkv, d, generator=gen) * mask[..., None]
    kb = ((1.0 - mask) * -1e9).contiguous()
    s = d ** -0.5
    w = {n: torch.randn(o, i, generator=gen) * s
         for n, (o, i) in dict(wqkv=(3 * d, d), wo=(d, d), wq=(d, d),
                                wkv=(2 * d, d), w1=(inter, d),
                                w2=(d, inter)).items()}
    v = {n: 0.1 * torch.randn(o, generator=gen)
         for n, o in dict(bqkv=3 * d, bo=d, bq=d, bkv=2 * d, b1=inter,
                          b2=d).items()}
    g = 1.0 + 0.1 * torch.randn(d, generator=gen)
    b = 0.1 * torch.randn(d, generator=gen)
    return gen, x, mem, kb, w, v, g, b


def check_blocks(lib, raw, items, nq, nkv, d, heads, inter):
    """B1-B3 fp32 against their plain versions."""
    _, x, mem, kb, w, v, g, b = _inputs(items + d + inter, items, nq, nkv, d,
                                        inter)
    rows = items * nq
    scale = fq._scale(d // heads, torch.float32)
    out = torch.empty_like(x)
    qkv, ctx, acc = (torch.empty(rows, 3 * d), torch.empty(rows, d),
                     torch.empty(rows, d))
    where = f"items {items} K {nq} D {d} heads {heads}"
    _twice(raw, lambda: lib.unirec_qformer_self_block_f32(
        _p(x), _p(w["wqkv"]), _p(v["bqkv"]), _p(w["wo"]), _p(v["bo"]), _p(g),
        _p(b), _p(out), _p(qkv), _p(ctx), _p(acc), items, nq, d, heads, scale,
        1e-12, None), [out], x, w["wqkv"], v["bqkv"], w["wo"], v["bo"], g, b,
        qkv, ctx, acc)
    _hold(f"B1 fp32 {where}", out, fq.fused_self_attention_block_plain(
        x, w["wqkv"], v["bqkv"], w["wo"], v["bo"], g, b, num_heads=heads,
        n_q=nq))
    q, kv = torch.empty(rows, d), torch.empty(items * nkv, 2 * d)
    _twice(raw, lambda: lib.unirec_qformer_cross_block_f32(
        _p(x), _p(mem), _p(kb), _p(w["wq"]), _p(v["bq"]), _p(w["wkv"]),
        _p(v["bkv"]), _p(w["wo"]), _p(v["bo"]), _p(g), _p(b), _p(out), _p(q),
        _p(kv), _p(ctx), _p(acc), items, nq, nkv, d, d, heads, scale, 1e-12,
        None), [out], x, mem, kb, w["wq"], v["bq"], w["wkv"], v["bkv"],
        w["wo"], v["bo"], g, b, q, kv, ctx, acc)
    _hold(f"B2 fp32 {where} F {nkv}", out,
          fq.fused_cross_attention_block_plain(
              x, mem, kb, w["wq"], v["bq"], w["wkv"], v["bkv"], w["wo"],
              v["bo"], g, b, num_heads=heads, n_q=nq, n_kv=nkv))
    h = torch.empty(rows, inter)
    _twice(raw, lambda: lib.unirec_qformer_ffn_block_f32(
        _p(x), _p(w["w1"]), _p(v["b1"]), _p(w["w2"]), _p(v["b2"]), _p(g),
        _p(b), _p(out), _p(h), _p(acc), rows, d, inter, 1e-12, None), [out],
        x, w["w1"], v["b1"], w["w2"], v["b2"], g, b, h, acc)
    _hold(f"B3 fp32 {where} I {inter}", out, fq.fused_ffn_block_plain(
        x, w["w1"], v["b1"], w["w2"], v["b2"], g, b))


def check_b12(lib, raw, items, nq, nkv, d, heads):
    """B12s / B12c fp32 forward and backward against their plain versions."""
    gen, x, mem, kb, w, v, _, _ = _inputs(items * 3 + nq + nkv + d, items, nq,
                                          nkv, d, 8)
    rows, mrows = items * nq, items * nkv
    x2, mem2 = x.reshape(rows, d), mem.reshape(mrows, d)
    self_kb = torch.zeros(rows)
    self_kb[1::5] = -1e9  # masked query rows of the self block's keys
    cross_kb = kb.reshape(mrows).contiguous()
    dout = torch.randn(rows, d, generator=gen)
    scale = fv._scale(d // heads)
    where = f"items {items} K {nq} F {nkv} D {d} heads {heads}"
    out, qkv, ctx = (torch.empty(rows, d), torch.empty(rows, 3 * d),
                     torch.empty(rows, d))
    _twice(raw, lambda: lib.unirec_b12_self_fwd_f32(
        _p(x2), _p(w["wqkv"]), _p(v["bqkv"]), _p(w["wo"]), _p(v["bo"]),
        _p(self_kb), _p(out), _p(qkv), _p(ctx), items, nq, d, heads, scale,
        None), [out, qkv, ctx], x2, w["wqkv"], v["bqkv"], w["wo"], v["bo"],
        self_kb)
    ref = fv.self_attention_fwd_plain(x2, self_kb, w["wqkv"], v["bqkv"],
                                      w["wo"], v["bo"], num_heads=heads,
                                      n_q=nq)
    _hold(f"B12s fwd fp32 {where}", out, ref[0])
    wo_t = w["wo"].t().contiguous()
    dctx = torch.empty(rows, d)
    stats = torch.empty(items * heads * nq * 3)
    dqkv = torch.empty(rows, 3 * d)
    _twice(raw, lambda: lib.unirec_b12_self_bwd_f32(
        _p(ref[1]), _p(wo_t), _p(self_kb), _p(dout), _p(dctx), _p(stats),
        _p(dqkv), items, nq, d, heads, scale, None), [dqkv], ref[1], wo_t,
        self_kb, dout, dctx, stats)
    dref = fv.self_attention_bwd_plain(ref[1], w["wo"], self_kb, dout,
                                       num_heads=heads, n_q=nq)
    for i, part in enumerate("qkv"):
        _hold(f"B12s bwd fp32 d{part} {where}",
                  dqkv[:, i * d:(i + 1) * d], dref[:, i * d:(i + 1) * d])
    q, kv = torch.empty(rows, d), torch.empty(mrows, 2 * d)
    _twice(raw, lambda: lib.unirec_b12_cross_fwd_f32(
        _p(x2), _p(mem2), _p(cross_kb), _p(w["wq"]), _p(v["bq"]),
        _p(w["wkv"]), _p(v["bkv"]), _p(w["wo"]), _p(v["bo"]), _p(out), _p(q),
        _p(kv), _p(ctx), items, nq, nkv, d, d, heads, scale, None),
        [out, q, kv, ctx], x2, mem2, cross_kb, w["wq"], v["bq"], w["wkv"],
        v["bkv"], w["wo"], v["bo"])
    ref = fv.cross_attention_fwd_plain(x2, mem2, cross_kb, w["wq"], v["bq"],
                                       w["wkv"], v["bkv"], w["wo"], v["bo"],
                                       num_heads=heads, n_q=nq, n_kv=nkv)
    _hold(f"B12c fwd fp32 {where}", out, ref[0])
    dq, dkv = torch.empty(rows, d), torch.empty(mrows, 2 * d)
    _twice(raw, lambda: lib.unirec_b12_cross_bwd_f32(
        _p(ref[1]), _p(ref[2]), _p(wo_t), _p(cross_kb), _p(dout), _p(dctx),
        _p(stats), _p(dq), _p(dkv), items, nq, nkv, d, heads, scale, None),
        [dq, dkv], ref[1], ref[2], wo_t, cross_kb, dout, dctx, stats)
    dref = fv.cross_attention_bwd_plain(ref[1], ref[2], w["wo"], cross_kb,
                                        dout, num_heads=heads, n_q=nq,
                                        n_kv=nkv)
    _hold(f"B12c bwd fp32 dq {where}", dq, dref[0])
    _hold(f"B12c bwd fp32 dk {where}", dkv[:, :d], dref[1][:, :d])
    _hold(f"B12c bwd fp32 dv {where}", dkv[:, d:], dref[1][:, d:])


def main() -> int:
    raw, lib = _emulated()
    check_blocks(lib, raw, 3, 8, 6, 64, 2, 136)
    check_blocks(lib, raw, 2, 8, 5, 100, 1, 72)  # hd 100: two column chunks
    check_b12(lib, raw, 3, 8, 6, 64, 2)
    check_b12(lib, raw, 2, 8, 5, 100, 1)
    check_b12(lib, raw, 2, 70, 67, 32, 2)  # two query tiles, two key tiles
    print("every fp32 block matches its plain version")
    return 0


if __name__ == "__main__":
    sys.exit(main())
