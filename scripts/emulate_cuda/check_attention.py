"""Run the port's attention kernels in a CPU emulation of CUDA and hold them
to their plain versions: a check of their index and fragment logic before a
card sees them (no timing).

    python3 scripts/emulate_cuda/check_attention.py [--hd 8,24,64,256]
        [--parent OTHER_ROOT]

Head dims above 256 (``--hd 320,512``) run the chunked form of
``flash_chunked.cuh`` (2 chunks of 256; also B13 / B14 over 300 keys, where
the forward splits the keys over two blocks and merges them; about fifteen
minutes for bf16, about as long again for float32's 3xTF32 cluster form).

The sources of ``unirec_tpu_torch/csrc`` are compiled with ``g++`` against
the headers beside this script (``emu.h``: CUDA threads as OS threads,
``ptx_helpers.cuh``: ldmatrix, mma.sync and cp.async from their documented
fragment layouts) into ``build/emulate_cuda/`` at the repository root, and
the port's wrappers are pointed at that library with CPU tensors.  Per head
dim, float32 and bf16: B13, B14 (merged heads) and B14p (per-head) forward
and backward at one q tile, at one query and at three q tiles over a ragged
memory with ~15% masked keys and one user masked whole; then K1 and B7b
with GQA 2:1 and 1:1 over padded rows.  Each against its plain version
(max|d| / max|ref|: 1e-5 for float32 outputs, 2e-2 for bf16 ones), the
masked user's uniform average, exactly zero dk / dv at masked keys,
identical bits on a repeat.  With ``--parent``, the float32 B13 / B14
outputs (merged heads, one q tile) at head dims up to 256 must equal
OTHER_ROOT's bit for bit, its C entries run on the same inputs
zero-padded as the wrappers pad them (above 256 float32 runs the 3xTF32
cluster form, whose bits a parent's scalar form need not have).
A few seconds a case; hd 256 takes about a minute.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
import types
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from unirec_tpu_torch.ops import _build  # noqa: E402
from unirec_tpu_torch.ops import attention as pa  # noqa: E402
from unirec_tpu_torch.ops import flash_causal as fc  # noqa: E402
from unirec_tpu_torch.ops import flash_vjp as fl  # noqa: E402

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
SOURCES = ("flash_causal_fwd.cu", "flash_causal_bwd.cu", "flash_cross.cu")


def _launches(text: str) -> str:
    """``kernel<<<grid, block, smem, stream>>>(args`` ->
    ``emu::launch(grid, block, smem, &kernel, args``."""
    out, i = [], 0
    while (j := text.find("<<<", i)) >= 0:
        k = j
        if text[k - 1] == ">":  # template arguments, backwards
            depth, k = 0, k - 1
            while True:
                depth += {">": 1, "<": -1}.get(text[k], 0)
                if depth == 0:
                    break
                k -= 1
        start = re.search(r"[A-Za-z_]\w*$", text[:k]).start()
        e = text.find(">>>(", j)
        parts, depth, cur = [], 0, ""
        for c in text[j + 3:e]:
            depth += (c in "([") - (c in ")]")
            if c == "," and depth == 0:
                parts.append(cur)
                cur = ""
            else:
                cur += c
        out += [text[i:start], f"emu::launch({parts[0]}, {parts[1]}, "
                f"{parts[2]}, &{text[start:j]}, "]
        i = e + 4
    return "".join(out) + text[i:]


def build(csrc: Path, work: Path, sources=SOURCES,
          extra: dict | None = None) -> ctypes.CDLL:
    """Compile ``sources`` of ``csrc`` (and ``extra``: file name -> text of
    more sources beside them) for the emulation into ``work``."""
    shutil.rmtree(work, ignore_errors=True)
    src = work / "src"
    src.mkdir(parents=True)
    for p in csrc.iterdir():
        if p.suffix in (".cu", ".cuh"):
            shutil.copy(p, src / p.name)
    for name, text in (extra or {}).items():
        (src / name).write_text(text)
    sources = (*sources, *(extra or {}))
    def emulated(text: str) -> str:  # shared memory and launches rewritten
        return _launches(re.sub(
            r"extern __shared__ (?:__align__\(\d+\) )?([\w ]+?)\s+(\w+)\[\];",
            r"\1* \2 = reinterpret_cast<\1*>(emu::smem_base);", text))

    for p in src.glob("*.cuh"):
        p.write_text(emulated(p.read_text()))
    shutil.copy(HERE / "ptx_helpers.cuh", src / "ptx_helpers.cuh")
    units = []
    for name in sources:
        unit = src / (Path(name).stem + ".cpp")
        unit.write_text(emulated((src / name).read_text()))
        units.append(unit)
    units.append(HERE / "api.cpp")
    objs = [work / (u.stem + ".o") for u in units]
    procs = [subprocess.Popen(
        ["g++", "-O1", "-std=c++20", "-fPIC", "-pthread", "-w", "-I",
         str(HERE / "include"), "-c", str(u), "-o", str(o)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for u, o in zip(units, objs)]
    logs = [p.communicate()[0] for p in procs]
    if any(p.returncode for p in procs):
        raise RuntimeError("g++ failed:\n" + "".join(logs))
    lib = work / "libemulated.so"
    subprocess.run(["g++", "-shared", "-pthread", "-o", str(lib),
                    *map(str, objs)], check=True)
    raw = ctypes.CDLL(str(lib))
    raw.emu_fault.restype = ctypes.c_char_p
    raw.emu_register.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    return raw


class _Entries:
    """The library as ``_build.bind`` sees it: entries of sources not built
    here get a placeholder."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        try:
            return getattr(self._lib, name)
        except AttributeError:
            setattr(self, name, types.SimpleNamespace())
            return getattr(self, name)


class Emulated:
    """The port's wrappers launching into the emulated library."""

    def __init__(self, raw):
        self.raw = raw
        kernels = _build.Kernels(_build.bind(_Entries(raw)), None, 0.0, "")
        for mod in (pa, fl, fc):
            mod.load_kernels = lambda: kernels
        torch.cuda.current_stream = (
            lambda device=None: types.SimpleNamespace(cuda_stream=None))
        fc._check_kernel_inputs = lambda *a, **k: None
        pa._sm_count = lambda index: 132  # an H100's SMs (key splits)
        pad = pa._pad_heads

        def pad_and_register(t, heads, hd):
            out = pad(t, heads, hd)
            self.register(out)
            return out
        pa._pad_heads = pad_and_register

    def register(self, *tensors):
        for t in tensors:
            self.raw.emu_register(t.data_ptr(), t.untyped_storage().nbytes())

    def run(self, fn, *tensors):
        """fn() with ``tensors`` as the global memory cp.async may read."""
        self.raw.emu_clear()
        self.register(*tensors)
        out = fn()
        fault = self.raw.emu_fault()
        if fault:
            raise AssertionError(fault.decode())
        return out


def _rel(got, ref) -> float:
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


def _hold(name, got, ref, dtype=None):
    err = _rel(got, ref)
    tol = TOL[dtype or got.dtype]
    if not err <= tol:
        raise AssertionError(f"{name}: {err:.2e} > {tol:g}")
    return err


def check_cross(emu, dtype, hd, b, h, lq, lkv, merged, parent=None):
    gen = torch.Generator().manual_seed(hd * 1000 + lq)
    q, do = (torch.randn(b, lq, h * hd, generator=gen).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, lkv, h * hd, generator=gen).to(dtype)
            for _ in range(2))
    mask = (torch.rand(b, lkv, generator=gen) > 0.15).float()
    mask[1] = 0.0
    bias32 = ((1.0 - mask) * -1e9).contiguous()
    per_head = {} if merged else {
        id(t): fl._heads(t, h).contiguous() for t in (q, k, v, do)}

    def heads(t):
        return per_head.get(id(t), fl._heads(t, h))

    ins = (q, k, v, do, bias32, *per_head.values())
    o = torch.empty(b, lq, h * hd)
    m, l = torch.empty(b, lq, h), torch.empty(b, lq, h)
    emu.run(lambda: pa.launch_flash_cross_fwd(*map(heads, (q, k, v)), bias32,
                                              heads(o), m, l), *ins)
    ro, rm, rl = fl.flash_cross_fwd_plain(q, k, v, bias32, h)
    errs = [_hold("o", o, ro), _hold("m", m, rm), _hold("l", l, rl)]
    o13 = torch.empty(b, lq, h, hd, dtype=dtype).transpose(1, 2)
    emu.run(lambda: pa.launch_flash_cross_fwd(*map(heads, (q, k, v)), bias32,
                                              o13), *ins)
    errs.append(_hold("B13 o", o13, pa.flash_cross_attention_plain(
        *(fl._heads(t, h) for t in (q, k, v)), bias32[:, None, None, :])))
    _hold("masked user", fl._heads(o, h)[1],
          fl._heads(v, h)[1].float().mean(1, keepdim=True).expand(h, lq, hd),
          dtype)
    dsum = fl.attention_dsum(do, o, h).contiguous()

    def bwd():
        grads = [torch.empty_like(t) for t in (q, k, v)]
        emu.run(lambda: fl.launch_flash_cross_bwd(
            *map(heads, (q, k, v)), bias32, heads(do), m, l, dsum,
            *map(heads, grads)), *ins)
        return grads

    grads = bwd()
    want = fl.flash_cross_bwd_plain(q, k, v, bias32, do, m, l, dsum, h)
    errs += [_hold(n, g, r) for n, g, r in zip(("dq", "dk", "dv"), grads,
                                                 want)]
    masked = mask == 0
    masked[1] = False
    if not all(bool((g.reshape(b, lkv, h, hd)[masked] == 0).all())
               for g in grads[1:]):
        raise AssertionError("a masked key got a gradient")
    if not all(torch.equal(x, y) for x, y in zip(grads, bwd())):
        raise AssertionError("a repeat gave other bits")
    same = ""
    # the float32 kernels above 256 are another form (3xTF32 in a cluster)
    # than the scalar one a parent may run: its bits are held at hd <= 256
    if parent is not None and dtype == torch.float32 and merged and hd <= 256:
        if not _parent_bits(parent, q, k, v, do, bias32, dsum, m, l, h, hd,
                            (o, m, l, *grads)):
            raise AssertionError("float32 outputs are not the parent's bits")
        same = ", the parent's bits"
    print(f"B13/B14/B14p {str(dtype)[6:]} hd {hd} B {b} H {h} Lq {lq} "
          f"Lkv {lkv} {'merged' if merged else 'per-head'}: max rel "
          f"{max(errs):.1e}{same}", flush=True)


def _padded_to_chunks(hd, inputs, outputs, launch):
    """``launch(ins, outs, width)`` on per-head views zero-padded to the
    kernels' width, instance * chunks (the C entries' head dim before the
    chunked form took a head dim as it is), the true columns copied back."""
    instance, chunks = pa.kernel_head_dim("parent", hd)
    width = instance * chunks
    ins = [pa._pad_heads(t, None, width) for t in inputs]
    outs = [torch.empty(*t.shape[:-1], width, dtype=t.dtype) for t in outputs]
    launch(ins, outs, width)
    for t, out in zip(outputs, outs):
        t.copy_(out[..., :hd])


def _parent_bits(parent, q, k, v, do, bias32, dsum, m, l, h, hd, ours):
    """The other tree's float32 kernels (C entries of that tree's
    signature) on the same inputs, zero-padded to whole chunks as that
    tree's wrappers padded them, compared bit for bit."""
    b, lq, _ = q.shape
    lkv = k.shape[1]
    o, m2, l2 = torch.empty_like(q), torch.empty_like(m), torch.empty_like(l)
    grads = [torch.empty_like(t) for t in (q, k, v)]
    errs = []
    parent.emu_clear()

    def fwd(ins, outs, kernel_hd):
        strides = [s for t in (*ins, *outs) for s in t.stride()[:3]]
        errs.append(parent.unirec_flash_cross_fwd(
            *(t.data_ptr() for t in (*ins, bias32, outs[0], m2, l2)), None,
            *strides, b, h, lq, lkv, kernel_hd, 0, 1, pa.sm_scale(hd), None))

    def bwd(ins, outs, kernel_hd):
        strides = [s for t in (*ins, *outs) for s in t.stride()[:3]]
        errs.append(parent.unirec_flash_cross_bwd(
            *(t.data_ptr() for t in (*ins[:3], bias32, ins[3], m, l, dsum,
                                     *outs)), None,
            (ctypes.c_longlong * 21)(*strides), b, h, lq, lkv, kernel_hd, 0,
            pa.sm_scale(hd), None))

    def heads(t):
        return fl._heads(t, h)

    _padded_to_chunks(hd, [heads(t) for t in (q, k, v)], [heads(o)], fwd)
    _padded_to_chunks(hd, [heads(t) for t in (q, k, v, do)],
                      [heads(g) for g in grads], bwd)
    return not any(errs) and all(torch.equal(x, y)
                                 for x, y in zip(ours, (o, m2, l2, *grads)))


def check_causal(emu, dtype, hd, hkv):
    gen = torch.Generator().manual_seed(hd + hkv)
    b, seq, hq = 2, 150, 4
    q, do = (torch.randn(b, seq, hq * hd, generator=gen).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, seq, hkv * hd, generator=gen).to(dtype)
            for _ in range(2))
    mask = torch.ones(b, seq)
    mask[0, 10:80] = 0.0
    mask[1, 100:] = 0.0
    ins = (q, k, v, do, mask)
    fc.flash_causal_attention.forms.clear()
    o, m, den = emu.run(lambda: fc._k1(q, k, v, mask, hq, hkv, stats=True),
                        *ins)
    k1_form = expected_forms(hd, dtype)[0]
    if dict(fc.flash_causal_attention.forms) != ({k1_form: 1} if k1_form
                                                 else {}):
        raise AssertionError(f"K1 ran {dict(fc.flash_causal_attention.forms)}")
    ref = fc.flash_causal_attention_fwd_plain(q.float(), k.float(), v.float(),
                                              mask, hq, hkv)
    errs = [_hold("K1 " + n, g, r, dtype) for n, g, r in
            zip(("o", "m", "l"), (o, m, den), ref)]
    dsum = fc.attention_dsum(do, o, hq).contiguous()
    args = (q, k, v, mask, do, m, den, dsum, hq, hkv)
    counters = (fc.flash_causal_attention, fc.flash_causal_bwd_dq,
                fc.flash_causal_bwd_dkv)
    for fn in counters:
        fn.forms.clear()
    dq = emu.run(lambda: fc.flash_causal_bwd_dq(*args), *ins, m, den, dsum)
    dk, dv = emu.run(lambda: fc.flash_causal_bwd_dkv(*args), *ins, m, den,
                     dsum)
    forms = [dict(fn.forms) for fn in counters]
    if forms != [{}] + [{f: 1} if f else {} for f in expected_forms(hd, dtype)[1:]]:
        raise AssertionError(f"B7b ran the forms {forms[1:]}")
    again = emu.run(lambda: fc.flash_causal_bwd_dkv(*args), *ins, m, den,
                    dsum)
    if not (torch.equal(dk, again[0]) and torch.equal(dv, again[1])):
        raise AssertionError("B7b's dk / dv: a repeat gave other bits")
    want = fc.flash_causal_attention_bwd_plain(
        q.float(), k.float(), v.float(), mask, do.float(), m, den, dsum, hq,
        hkv)
    errs += [_hold("B7b " + n, g, r, dtype) for n, g, r in
             zip(("dq", "dk", "dv"), (dq, dk, dv), want)]
    pad = mask == 0
    if not (bool((dk[pad] == 0).all()) and bool((dv[pad] == 0).all())):
        raise AssertionError("B7b gave a padded key a gradient")
    print(f"K1/B7b {str(dtype)[6:]} hd {hd} Hq {hq} Hkv {hkv}: max rel "
          f"{max(errs):.1e}" + (f", forms (dq, dk / dv) {forms[1:]}"
                                if hd > 256 else ""), flush=True)


def expected_forms(hd: int, dtype) -> list:
    """The chunked form of K1, B7b's dq and B7b's dk / dv at ``hd``: bf16
    on tensor cores up to 5, 2 and 4 chunks of 256, in a cluster above
    those up to 8 (K1 and dq); float32 K1 and dq in the 3xTF32 cluster form
    up to 8 chunks; the scalar form above and for float32 dk / dv; none at
    hd <= 256."""
    if hd <= 256:
        return [None] * 3
    chunks = -(-hd // 256)
    if dtype != torch.bfloat16:
        return ["cluster_tf32" if chunks <= 8 else "scalar"] * 2 + ["scalar"]
    return ["tensor_cores" if chunks <= most else
            "cluster" if chunks <= cluster else "scalar"
            for most, cluster in ((5, 8), (2, 8), (4, 4))]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--hd", default="8,24,64,256",
                        help="head dims, comma-separated")
    parser.add_argument("--causal", action="store_true",
                        help="K1 and B7b only (no B13 / B14 / B14p)")
    parser.add_argument("--parent", help="another checkout to hold float32 "
                        "B13 / B14 bits to")
    parser.add_argument("--dtypes", default="bf16,fp32",
                        help="bf16 and / or fp32, comma-separated")
    args = parser.parse_args()
    dtypes = [{"bf16": torch.bfloat16, "fp32": torch.float32}[d]
              for d in args.dtypes.split(",")]
    work = ROOT / "build" / "emulate_cuda"
    emu = Emulated(build(ROOT / "unirec_tpu_torch" / "csrc", work / "this"))
    parent = None
    if args.parent:
        parent = build(Path(args.parent) / "unirec_tpu_torch" / "csrc",
                       work / "parent", ("flash_cross.cu",))
        P, I = ctypes.c_void_p, ctypes.c_int
        parent.unirec_flash_cross_fwd.argtypes = (
            [P] * 8 + [ctypes.c_longlong] * 12 + [I] * 7 + [ctypes.c_float, P])
        parent.unirec_flash_cross_bwd.argtypes = (
            [P] * 13 + [I] * 6 + [ctypes.c_float, P])
    for hd in map(int, args.hd.split(",")):
        for dtype in dtypes:
            for hkv in (2, 4):
                check_causal(emu, dtype, hd, hkv)
            if args.causal:
                continue
            check_cross(emu, dtype, hd, 3, 2, 64, 130, True, parent)
            check_cross(emu, dtype, hd, 2, 3, 1, 70, False)
            check_cross(emu, dtype, hd, 2, 1, 150, 100, False)
            if hd > 256:  # the forward's key splits
                check_cross(emu, dtype, hd, 2, 2, 64, 300, True)
    print("all emulated kernels agree with their plain versions")
    return 0


if __name__ == "__main__":
    sys.exit(main())
