"""Run the Item Q-Former's attention kernels in the CPU emulation of CUDA and
hold them to their plain versions: B12s and B12c forward and backward
(``csrc/fused_qformer_vjp.cu``: the projection GEMM of ``gemm_wide.cuh`` and
the per-item core of ``item_attention.cuh``), and the core in its B1
rounding, which B1/B2/B4/B5 launch (no timing).

    python3 scripts/emulate_cuda/check_item_blocks.py [--quick]

The sources are compiled with ``g++`` against the headers beside this script
(see ``check_attention.py``) into ``build/emulate_cuda/item/``, together with
a small unit exporting ``item_attention<IA_B1>`` as a C entry.  The cases
cover K in {1, 8, 32, 64, 128, 256}, F in {1, 2, 14, 300, 512} and head dims
{16, 64, 128, 255, 256, 512, 1024}: packed items, query and key tiles of one
item, resident and streamed tiles, rows that are not 16-byte aligned
(hidden 1020), ragged last blocks, ~15% missing fields and an item with none.
Each output is held to its plain version on the same bf16 inputs (max|d| /
max|ref| <= 2e-2 and per-row cosine >= 0.9999, as chip_smoke.py's kernel
gates; the rows of an item without fields leave B12c dq's cosine, whose
exact value is 0), and a repeat must give identical bits.  ``--quick`` runs
the cases at head dims up to 256 (about four minutes); all of them take
about fifteen.
"""

from __future__ import annotations

import argparse
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
from unirec_tpu_torch.ops import fused_qformer_layer as fq  # noqa: E402
from unirec_tpu_torch.ops import fused_qformer_vjp as fv  # noqa: E402

TOL, COS = 2e-2, 0.9999
B1_UNIT = """#include "item_attention.cuh"
extern "C" int emu_item_attention_b1(const void* q, int q_stride, const void* kv,
    int kv_stride, int k_off, int v_off, const float* key_bias, void* ctx,
    int ctx_stride, int items, int heads, int nq, int nkv, int hd, float scale,
    void* stream) {
  return (int)item_attention<IA_B1>(q, q_stride, kv, kv_stride, k_off, v_off,
      key_bias, ctx, ctx_stride, items, heads, nq, nkv, hd, scale,
      static_cast<cudaStream_t>(stream));
}
"""
# (items, K, F, d, heads, dm): F None = B12s; d 1020 takes the edge paths
B12_CASES = [
    (5, 32, None, 128, 2, None), (5, 32, 14, 128, 2, 96),
    (3, 1, None, 64, 4, None), (2, 1, 2, 64, 1, 64),
    (2, 128, None, 128, 1, None), (3, 128, 256, 256, 2, 128),
    (1, 256, None, 64, 1, None), (2, 256, 512, 64, 1, 64),
    (2, 8, None, 1020, 4, None), (2, 8, 8, 1020, 4, 100),
    (2, 8, None, 512, 2, None), (2, 8, 8, 512, 2, 64),
    (2, 64, None, 1024, 2, None), (1, 64, 64, 1024, 2, 64),
    (1, 64, None, 1024, 1, None), (1, 64, 128, 1024, 1, 64),
]
# (items, nq, nkv, heads, hd, bias): the core in B1's rounding
B1_CASES = [
    (5, 32, 14, 2, 64, True), (3, 32, 32, 1, 64, False),
    (2, 32, 300, 2, 64, True), (3, 32, 32, 1, 256, False),
    (2, 256, 256, 1, 128, False), (2, 8, 512, 1, 1024, True),
    (3, 1, 1, 2, 16, False), (2, 64, 14, 4, 255, True),
]


def _emulated():
    raw = build(ROOT / "unirec_tpu_torch" / "csrc",
                ROOT / "build" / "emulate_cuda" / "item",
                ("fused_qformer_vjp.cu",), {"b1_core.cu": B1_UNIT})
    raw.emu_fault.restype = ctypes.c_char_p
    raw.emu_register.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    raw.emu_item_attention_b1.argtypes = [P, I, P, I, I, I, P, P] + [I] * 6 + [F, P]
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


def _hold(name, got, ref, noise_rows=None):
    a = got.float().reshape(-1, got.shape[-1])
    b = ref.float().reshape(-1, ref.shape[-1])
    if not bool(torch.isfinite(a).all()):
        raise AssertionError(f"{name}: non-finite values")
    rel = ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
    live = b.abs().amax(-1) > 0
    if noise_rows is not None:
        live &= ~noise_rows
    cos = torch.nn.functional.cosine_similarity(a[live], b[live], dim=-1)
    cmin = cos.min().item() if live.any() else 1.0
    if not (rel <= TOL and cmin >= COS):
        raise AssertionError(f"{name}: rel {rel:.2e} (tol {TOL}), min row "
                             f"cosine {cmin:.6f} (tol {COS})")
    return rel


def _bf(gen, *shape, std=1.0):
    return (torch.randn(*shape, generator=gen) * std).bfloat16()


def check_b12(raw, lib, items, k, f, d, heads, dm):
    gen = torch.Generator().manual_seed(items * 1000 + k * 10 + d)
    cross = f is not None
    nkv = f if cross else k
    hd = d // heads
    x = _bf(gen, items * k, d)
    dout = _bf(gen, items * k, d, std=0.1)
    mask = (torch.rand(items, nkv, generator=gen) > 0.15).float()
    if cross and items > 1:  # an item with no field, beside others
        mask[items // 2] = 0.0
    kb = ((1.0 - mask) * -1e9).reshape(-1).contiguous()
    zero = torch.zeros(items * k)
    std = 1.0 / d ** 0.5
    scale = fv._scale(hd)
    noise = None
    if not cross:
        w = dict(wqkv=_bf(gen, 3 * d, d, std=std), bqkv=_bf(gen, 3 * d, std=0.1),
                 wo=_bf(gen, d, d, std=std), bo=_bf(gen, d, std=0.1))
        b32 = {n: w[n].float().contiguous() for n in ("bqkv", "bo")}
        kw = dict(num_heads=heads, n_q=k)
        ref = fv.self_attention_fwd_plain(x, zero, *w.values(), **kw)
        outs = [torch.empty_like(x), torch.empty(items * k, 3 * d).bfloat16(),
                torch.empty_like(x)]
        call = lambda: lib.unirec_b12_self_fwd(  # noqa: E731
            x.data_ptr(), w["wqkv"].data_ptr(), b32["bqkv"].data_ptr(),
            w["wo"].data_ptr(), b32["bo"].data_ptr(), zero.data_ptr(),
            *(o.data_ptr() for o in outs), items, k, d, heads, scale, None)
        ins = (x, zero, *w.values(), *b32.values())
        names = ("out", "qkv", "ctx")
        qkv = ref[1]  # the backward on the plain forward's residuals
        wo_t = w["wo"].t().contiguous()
        dctx = torch.empty(items * k, d)
        bouts = [torch.empty_like(qkv)]
        bcall = lambda: lib.unirec_b12_self_bwd(  # noqa: E731
            qkv.data_ptr(), wo_t.data_ptr(), zero.data_ptr(), dout.data_ptr(),
            dctx.data_ptr(), bouts[0].data_ptr(), items, k, d, heads, scale, None)
        bins = (qkv, wo_t, zero, dout, dctx)
        bref = (fv.self_attention_bwd_plain(qkv, w["wo"], zero, dout, **kw),)
        bnames = ("dqkv",)
    else:
        mem = _bf(gen, items * f, dm) * mask.reshape(-1, 1).bfloat16()
        w = dict(wq=_bf(gen, d, d, std=std), bq=_bf(gen, d, std=0.1),
                 wkv=_bf(gen, 2 * d, dm, std=dm ** -0.5),
                 bkv=_bf(gen, 2 * d, std=0.1), wo=_bf(gen, d, d, std=std),
                 bo=_bf(gen, d, std=0.1))
        b32 = {n: w[n].float().contiguous() for n in ("bq", "bkv", "bo")}
        kw = dict(num_heads=heads, n_q=k, n_kv=f)
        ref = fv.cross_attention_fwd_plain(x, mem, kb, *w.values(), **kw)
        outs = [torch.empty_like(x), torch.empty_like(x),
                torch.empty(items * f, 2 * d).bfloat16(), torch.empty_like(x)]
        call = lambda: lib.unirec_b12_cross_fwd(  # noqa: E731
            x.data_ptr(), mem.data_ptr(), kb.data_ptr(), w["wq"].data_ptr(),
            b32["bq"].data_ptr(), w["wkv"].data_ptr(), b32["bkv"].data_ptr(),
            w["wo"].data_ptr(), b32["bo"].data_ptr(),
            *(o.data_ptr() for o in outs), items, k, f, d, dm, heads, scale,
            None)
        ins = (x, mem, kb, *w.values(), *b32.values())
        names = ("out", "q", "kv", "ctx")
        q, kv = ref[1], ref[2]
        wo_t = w["wo"].t().contiguous()
        dctx = torch.empty(items * k, d)
        bouts = [torch.empty_like(q), torch.empty_like(kv)]
        bcall = lambda: lib.unirec_b12_cross_bwd(  # noqa: E731
            q.data_ptr(), kv.data_ptr(), wo_t.data_ptr(), kb.data_ptr(),
            dout.data_ptr(), dctx.data_ptr(), bouts[0].data_ptr(),
            bouts[1].data_ptr(), items, k, f, d, heads, scale, None)
        bins = (q, kv, wo_t, kb, dout, dctx)
        bref = fv.cross_attention_bwd_plain(q, kv, w["wo"], kb, dout, **kw)
        bnames = ("dq", "dkv")
        noise = (mask.sum(1) == 0).repeat_interleave(k)
    errs = []
    for fn, args, got, want, labels in ((call, ins, outs, ref, names),
                                        (bcall, bins, bouts, bref, bnames)):
        _run(raw, fn, *args, *got)
        first = [t.clone() for t in got]
        for n, g, r in zip(labels, got, want):
            errs.append(_hold(n, g, r, noise if n == "dq" else None))
        _run(raw, fn, *args, *got)
        if not all(torch.equal(a, b) for a, b in zip(first, got)):
            raise AssertionError("a repeat gave other bits")
    kind = f"B12c F {f} Dm {dm}" if cross else "B12s"
    print(f"{kind} items {items} K {k} D {d} heads {heads} (hd {hd}): fwd + "
          f"bwd max rel {max(errs):.1e}, repeats bit for bit", flush=True)


def check_b1(raw, items, nq, nkv, heads, hd, bias):
    gen = torch.Generator().manual_seed(items * 100 + nq + nkv + hd)
    d = heads * hd
    q = _bf(gen, items, nq, d)
    kv = _bf(gen, items, nkv, 2 * d)
    mask = (torch.rand(items, nkv, generator=gen) > 0.15).float()
    mask[-1] = 0.0
    kb = ((1.0 - mask) * -1e9).contiguous() if bias else None
    ref = fq._item_attention(q, kv[..., :d], kv[..., d:], kb, heads)
    ctx = torch.empty(items, nq, d).bfloat16()
    scale = fq._scale(hd, torch.bfloat16)
    ins = [q, kv, ctx] + ([kb] if bias else [])
    call = lambda: raw.emu_item_attention_b1(  # noqa: E731
        q.data_ptr(), d, kv.data_ptr(), 2 * d, 0, d,
        kb.data_ptr() if bias else None, ctx.data_ptr(), d, items, heads, nq,
        nkv, hd, scale, None)
    _run(raw, call, *ins)
    err = _hold("B1 ctx", ctx, ref)
    first = ctx.clone()
    _run(raw, call, *ins)
    if not torch.equal(first, ctx):
        raise AssertionError("a repeat gave other bits")
    print(f"core (B1 rounding) items {items} nq {nq} nkv {nkv} heads {heads} "
          f"hd {hd}{' bias' if bias else ''}: max rel {err:.1e}, repeats bit "
          "for bit", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--quick", action="store_true",
                        help="only the head dims up to 256")
    args = parser.parse_args()
    raw, lib = _emulated()
    for case in B1_CASES:
        if not (args.quick and case[4] > 256):
            check_b1(raw, *case)
    for case in B12_CASES:
        if not (args.quick and case[3] // case[4] > 256):
            check_b12(raw, lib, *case)
    print("all emulated item-attention kernels agree with their plain versions")
    return 0


if __name__ == "__main__":
    sys.exit(main())
