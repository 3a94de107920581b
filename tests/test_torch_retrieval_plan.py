"""K2's and B11's partition and selection order, on the CPU (the kernels
run on the card only: ``tests/test_torch_kernels_gpu.py``).

* ``retrieval_plan`` over a sweep of users, rows (one, fewer than the SMs,
  a share one row short) and widths (1, 3, 1021, 1024) on a card of 132
  SMs and one of 3: every catalog row in exactly one share, every user in
  exactly one group, every column in exactly one chunk, each share's stages
  in the kernel's order (tiles, then user groups, then chunks), tiles of
  whole 32-row slots, and the share bounds the kernels' entries accept.
* A Python model of the kernels' selection (per share, tile by tile, the
  rows that beat the running k-th entry merged into a top-32; then the
  shares' top-k lists merged in share order) equals ``top_k_items`` bit for
  bit on its own scores, with runs of equal rows across share boundaries
  (ties go to the lower index).
* The wrappers' checks (``kernel_inputs``, ``int8_kernel_inputs``) take
  every width, copy a base that is not 16-byte aligned, and still refuse k
  out of [1, min(N, 32)].
"""

import itertools

import pytest
import torch

from tests.torch_dist_ranks import one_torch_thread  # noqa: F401
from unirec_tpu_torch.ops.losses import l2_normalize
from unirec_tpu_torch.ops.quantization import int8_kernel_inputs, quantize_rows
from unirec_tpu_torch.ops.ranking import (
    CHUNK,
    TILE_ROWS,
    USER_GROUPS,
    kernel_inputs,
    retrieval_plan,
    top_k_items,
)


ROWS = (1, 3, 37, 131, 132, 133, 20_000, 20_001)
WIDTHS = (1, 3, 1021, 1024)


def _covers(parts, whole: range) -> bool:
    """``parts`` are non-empty ranges that tile ``whole`` in order."""
    flat = [x for p in parts for x in p]
    return all(len(p) for p in parts) and flat == list(whole)


@pytest.mark.parametrize("elem_bytes", [4, 1])
@pytest.mark.parametrize("users", [1, 8, 24, 64, 200])
def test_plan_covers_every_row_user_and_column_once(users, elem_bytes):
    for rows, width, sms in itertools.product(ROWS, WIDTHS, (132, 3)):
        plan = retrieval_plan(users, rows, width, elem_bytes, sms)
        ug = plan.users_per_group
        assert ug == next((g for g in USER_GROUPS if users <= g), 64)
        assert _covers([plan.group_users(g) for g in range(plan.groups)],
                       range(users))
        assert 1 <= plan.shares <= sms
        shares = [plan.share_rows(s) for s in range(plan.shares)]
        assert _covers(shares, range(rows))
        # the kernels' entries accept exactly these share bounds
        assert plan.shares * plan.rows_per_share >= rows
        assert (plan.shares - 1) * plan.rows_per_share < rows
        chunks = plan.chunks()
        assert _covers(chunks, range(width))
        assert all(len(c) <= CHUNK[elem_bytes] for c in chunks)
        assert plan.tile_rows % 32 == 0 and 32 <= plan.tile_rows <= TILE_ROWS
        for s in range(plan.shares):
            tiles = plan.tiles(s)
            assert _covers(tiles, shares[s])
            assert all(len(t) <= TILE_ROWS for t in tiles)
            assert plan.stages(s) == [
                (t, plan.group_users(g), c) for t in tiles
                for g in range(plan.groups) for c in chunks]


def _model_top_k(scores: torch.Tensor, k: int, plan):
    """The kernels' selection order over a score matrix, in exact Python
    comparisons (score descending, then index ascending)."""

    def key(entry):
        return (-entry[0], entry[1])

    def fold(run, cands):
        th = key(run[k - 1]) if len(run) >= k else None
        return sorted(run + [e for e in cands if th is None or key(e) < th],
                      key=key)[:32]

    vals, ids = [], []
    for row in scores.tolist():
        lists = []
        for s in range(plan.shares):
            run = []
            for tile in plan.tiles(s):
                run = fold(run, [(row[r], r) for r in tile])
            lists.append(run[:k])
        final = []
        for lst in lists:
            final = fold(final, lst)
        vals.append([e[0] for e in final[:k]])
        ids.append([e[1] for e in final[:k]])
    return torch.tensor(vals, dtype=torch.float32), torch.tensor(ids)


@pytest.mark.parametrize("users,rows,sms,k", [(3, 700, 5, 20),
                                              (8, 300, 132, 32),
                                              (2, 37, 4, 32),
                                              (4, 1000, 3, 1)])
def test_share_then_merge_equals_top_k_items(users, rows, sms, k):
    gen = torch.Generator().manual_seed(rows + k)
    plan = retrieval_plan(users, rows, 16, 4, sms)
    cat = torch.randn(rows, 16, generator=gen)
    for s in range(1, plan.shares):  # equal rows across every boundary
        edge = s * plan.rows_per_share
        cat[edge - 1:edge + 2] = cat[edge]
    u = torch.randn(users, 16, generator=gen)
    u[0] = cat[min(plan.rows_per_share, rows - 1)]
    scores = l2_normalize(u) @ l2_normalize(cat).T  # top_k_items' scores
    got_s, got_i = _model_top_k(scores, k, plan)
    want_s, want_i = top_k_items(u, cat, k=k)
    assert torch.equal(got_i, want_i) and torch.equal(got_s, want_s)
    if plan.shares > 1 and k >= 3:  # user 0's top 3 tie across a boundary
        edge = plan.rows_per_share
        assert got_i[0, :3].tolist() == [edge - 1, edge, edge + 1]


def test_share_then_merge_all_ties():
    cat = torch.ones(300, 8)
    plan = retrieval_plan(2, 300, 8, 4, 7)
    scores = l2_normalize(torch.ones(2, 8)) @ l2_normalize(cat).T
    got_s, got_i = _model_top_k(scores, 20, plan)
    want_s, want_i = top_k_items(torch.ones(2, 8), cat, k=20)
    assert got_i.tolist() == want_i.tolist() == [list(range(20))] * 2
    assert torch.equal(got_s, want_s)


@pytest.mark.parametrize("width", WIDTHS)
def test_kernel_inputs_take_any_width(width):
    gen = torch.Generator().manual_seed(width)
    users = torch.randn(5, width, generator=gen)
    cat = torch.randn(40, width, generator=gen)
    u, c = kernel_inputs(users, cat, 20)
    assert torch.equal(u, users) and torch.equal(c, cat)
    codes, scales = quantize_rows(cat)
    u8, c8, s8 = int8_kernel_inputs(users, codes, scales, 32)
    assert c8.dtype == torch.int8 and s8.shape == (40,)
    # a view one element into its storage is copied to an aligned base
    flat = torch.randn(40 * width + 1, generator=gen)
    view = flat[1:].view(40, width)
    assert view.data_ptr() % 16
    _, c = kernel_inputs(users, view, 5)
    assert c.data_ptr() % 16 == 0 and torch.equal(c, view)
    for t in (u, c, u8, c8):
        assert t.is_contiguous() and t.data_ptr() % 16 == 0
    for k in (0, 41, 33):
        with pytest.raises(ValueError, match="k must be"):
            kernel_inputs(users, cat if k != 33 else torch.randn(50, width),
                          k)
