"""Run K2 and B11 (``csrc/retrieve_topk.cu``) in the CPU emulation of CUDA
and hold them to their plain versions: a check of their index, copy and
selection logic before a card sees them (no timing).

    python3 scripts/emulate_cuda/check_retrieval.py

The source is compiled with ``g++`` as ``check_attention.py`` compiles the
attention kernels, and the port's launch functions
(``ops/ranking.launch_k2``, ``ops/quantization.launch_b11``) are pointed at
it with CPU tensors and an emulated card of 3 SMs, so that a few hundred
catalog rows make three shares with their boundaries inside runs of
duplicated rows. Cases: float32 at D 1024 and 1021 (TMA boxes and 4-byte
copies), 8 and 64 users, 72 users (two user groups, the lists waiting in the
shares' output between tiles, over one tile a share and three), without
normalisation (unit rows), 37 rows (two shares) and one row; int8 at D 1024,
1020 and 1021 (TMA boxes, 4-byte copies and plain loads) with 8, 16, 64 and
72 users, and three tiles a share. Catalogs hold a zero row and rows of norms
from 1e-6 to 1e6. Each result against the plain version (``top_k_items`` /
``quantized_top_k``): scores within 1e-5, ids equal but where the plain
scores of the two picks are within 1e-6 (near-ties), every tie of equal rows
to the lower index, identical bits on a repeat, one launch-counter increment
a call. About three minutes.
"""

from __future__ import annotations

import sys
import types
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(HERE))

import torch  # noqa: E402

from check_attention import _Entries, build  # noqa: E402
from unirec_tpu_torch.ops import _build  # noqa: E402
from unirec_tpu_torch.ops import quantization as qz  # noqa: E402
from unirec_tpu_torch.ops import ranking as rk  # noqa: E402

SCORE_TOL, TIE = 1e-5, 1e-6
SMS = 3  # the emulated card's SM count: three shares


class Emulated:
    """The launch functions of K2 and B11 running the emulated library."""

    def __init__(self, raw):
        self.raw = raw
        kernels = _build.Kernels(_build.bind(_Entries(raw)), None, 0.0, "")
        for mod in (rk, qz):
            mod.load_kernels = lambda: kernels
            mod.sm_count = lambda device: SMS
        torch.cuda.current_stream = (
            lambda device=None: types.SimpleNamespace(cuda_stream=None))

    def run(self, fn, *inputs):
        self.raw.emu_clear()
        for t in inputs:
            self.raw.emu_register(t.data_ptr(), t.untyped_storage().nbytes())
        out = fn()
        fault = self.raw.emu_fault()
        if fault:
            raise AssertionError(fault.decode())
        return out


def catalog_rows(gen, n, d, plan):
    """Random rows with a zero row, norms from 1e-6 to 1e6, and a run of
    three equal rows across every share boundary."""
    c = torch.randn(n, d, generator=gen)
    c *= torch.logspace(-6, 6, n)[torch.randperm(n, generator=gen)][:, None]
    c[min(5, n - 1)] = 0.0
    for s in range(1, plan.shares):
        edge = s * plan.rows_per_share
        c[edge - 1:edge + 2] = c[edge]
    return c


def hold(name, got, ref, full):
    (s, i), (s_ref, i_ref) = got, ref
    err = (s - s_ref).abs().max().item()
    if not err <= SCORE_TOL:
        raise AssertionError(f"{name}: scores differ by {err:.2e}")
    diff = i != i_ref
    if diff.any():
        gap = (full.gather(1, i) - s_ref)[diff].abs().max().item()
        if not gap < TIE:
            raise AssertionError(f"{name}: ids differ beyond near-ties ({gap})")
    return err, int(diff.sum())


def once(counter, before, name):
    if counter.launches != before + 1:
        raise AssertionError(f"{name}: launch counter not raised by one")


def ties_low(name, s, i):
    """Equal scores within a user's list come in ascending index order."""
    eq = s[:, 1:] == s[:, :-1]
    if bool((eq & (i[:, 1:] < i[:, :-1])).any()):
        raise AssertionError(f"{name}: a tie went to the higher index")


def check_k2(emu, b, n, d, k, normalize=True, seed=0):
    gen = torch.Generator().manual_seed(seed)
    plan = rk.retrieval_plan(b, n, d, 4, SMS)
    cat = catalog_rows(gen, n, d, plan)
    users = torch.randn(b, d, generator=gen)
    users[0] = cat[min(plan.rows_per_share, n - 1)] * 3.0  # ties at a boundary
    if not normalize:  # raw dot products of unit rows, as the callers pass
        cat, users = rk.l2_normalize(cat), rk.l2_normalize(users)
    before = rk.retrieve_top_k.launches
    got = emu.run(lambda: rk.launch_k2(users, cat, k, normalize), users, cat)
    once(rk.retrieve_top_k, before, "K2")
    again = emu.run(lambda: rk.launch_k2(users, cat, k, normalize), users,
                    cat)
    if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
        raise AssertionError("K2: a repeat gave other bits")
    ref = rk.top_k_items(users, cat, k, normalize)
    full = rk.folded_scores(users, cat, normalize)
    err, swaps = hold(f"K2 B {b} N {n} D {d}", got, ref, full)
    ties_low("K2", *got)
    print(f"K2 B {b} N {n} D {d} k {k} normalize {normalize}: plan "
          f"{plan.shares} shares x {plan.rows_per_share} rows, "
          f"{plan.groups} group(s) of {plan.users_per_group}; max|d score| "
          f"{err:.1e}, near-tie swaps {swaps}", flush=True)


def check_b11(emu, b, n, d, k, seed=1):
    gen = torch.Generator().manual_seed(seed)
    plan = rk.retrieval_plan(b, n, d, 1, SMS)
    codes, scales = qz.quantize_rows(catalog_rows(gen, n, d, plan))
    users = torch.randn(b, d, generator=gen)
    before = qz.retrieve_top_k_int8.launches
    got = emu.run(lambda: qz.launch_b11(users, codes, scales, k), users,
                  codes, scales)
    once(qz.retrieve_top_k_int8, before, "B11")
    again = emu.run(lambda: qz.launch_b11(users, codes, scales, k), users,
                    codes, scales)
    if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
        raise AssertionError("B11: a repeat gave other bits")
    ref = qz.quantized_top_k(users, codes, scales, k)
    full = qz.quantized_scores(users, codes, scales)
    err, swaps = hold(f"B11 B {b} N {n} D {d}", got, ref, full)
    ties_low("B11", *got)
    print(f"B11 B {b} N {n} D {d} k {k}: plan {plan.shares} shares x "
          f"{plan.rows_per_share} rows, {plan.groups} group(s) of "
          f"{plan.users_per_group}; max|d score| {err:.1e}, near-tie swaps "
          f"{swaps}", flush=True)


def main() -> int:
    emu = Emulated(build(ROOT / "unirec_tpu_torch" / "csrc",
                         ROOT / "build" / "emulate_cuda" / "retrieval",
                         ("retrieve_topk.cu",)))
    for d in (1024, 1021):
        check_k2(emu, 8, 300, d, 20)
        check_k2(emu, 64, 300, d, 20)
    check_k2(emu, 72, 160, 40, 32)
    check_k2(emu, 72, 800, 24, 20)  # three tiles a share, two groups
    check_k2(emu, 8, 300, 1024, 20, normalize=False)
    check_k2(emu, 24, 37, 33, 32)
    check_k2(emu, 1, 1, 7, 1)
    check_b11(emu, 8, 300, 1024, 20)
    check_b11(emu, 16, 300, 1020, 20)
    check_b11(emu, 64, 300, 1021, 32)
    check_b11(emu, 72, 100, 21, 5)
    check_b11(emu, 8, 900, 64, 20)  # three tiles a share
    print("K2 and B11 agree with their plain versions in the emulation")
    return 0


if __name__ == "__main__":
    sys.exit(main())
