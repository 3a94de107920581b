"""Candidate-pool ranking and full-catalog retrieval (port of
``unirec_tpu/ops/ranking.py``): ``rank_of_positive`` and ``ranking_metrics``
(the joint trainer's evaluation), the plain ``top_k_items`` and the
retrieval kernel K2.

K2 (``csrc/retrieve_topk.cu``, ``unirec_retrieve_topk``) replaces
``unirec_tpu/ops/ranking.py::retrieve_top_k`` (``_retrieval_kernel`` :118
with ``merge_running_topk`` :92, called at :214). It reads the catalog from
HBM once a call at any user count: a persistent grid of one CTA per SM
streams equal contiguous shares of rows (``retrieval_plan``) through a ring
of shared-memory stages that a producer warp fills by TMA, folds the L2
normalisation of users and rows into the epilogue (``folded_scores`` is its
arithmetic in plain PyTorch), keeps a running top-k per user, and a second
launch merges the shares' lists. At 8 users it is bound by reading the
catalog (about 82 MB in fp32 at 20,000 x 1,024), at 64 by its fp32 FMAs; the
source note says what the design does about each. The [B, N] score matrix
never reaches device memory, nor does a normalised copy of either input.

Both return scores ``[B, k]`` float32 in descending order and catalog ids
``[B, k]`` int64; equal scores go to the lower catalog index.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from unirec_tpu_torch.ops._build import check, load_kernels
from unirec_tpu_torch.ops.losses import l2_normalize, normalize_promoted

MAX_KERNEL_K = 32  # the kernel keeps k <= 32 candidates per user on chip
NORM_EPS = 1e-12
# the kernel's tile and chunk (csrc/retrieve_topk.cu: TR, Cfg::DC): catalog
# rows a CTA scores at once, and row elements a ring stage holds by element
# size (512 bytes of a float32 row, 256 int8 codes)
TILE_ROWS = 128
CHUNK = {4: 128, 1: 256}
USER_GROUPS = (8, 16, 32, 64)  # the kernel's instances of users a group
MIN_SHARE_ROWS = 32


def rank_of_positive(user_emb: torch.Tensor, positive_emb: torch.Tensor,
                     negative_emb: torch.Tensor,
                     negative_mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """1-based rank of the positive among [positive] + negatives by cosine
    similarity: 1 + the number of negatives scoring strictly higher (ties go
    to the positive; a masked negative scores -inf)."""
    u, p, n = normalize_promoted(user_emb, positive_emb, negative_emb)
    pos_sim = (u * p).sum(-1)                             # [B]
    neg_sim = torch.einsum("bd,bnd->bn", u, n)            # [B, N]
    if negative_mask is not None:
        neg_sim = torch.where(negative_mask.bool(), neg_sim,
                              torch.full_like(neg_sim, float("-inf")))
    return 1 + (neg_sim > pos_sim[:, None]).sum(-1)


def ranking_metrics(user_emb: torch.Tensor, positive_emb: torch.Tensor,
                    negative_emb: torch.Tensor,
                    negative_mask: Optional[torch.Tensor] = None,
                    ks: Tuple[int, ...] = (1, 5, 10)
                    ) -> Dict[str, torch.Tensor]:
    """MRR, Recall@K and NDCG@K for one relevant item per user: Recall@K is
    hit@K, NDCG@K is 1/log2(rank + 1) within K and 0 beyond."""
    ranks = rank_of_positive(user_emb, positive_emb, negative_emb,
                             negative_mask)
    out: Dict[str, torch.Tensor] = {"mrr": (1.0 / ranks).mean()}
    for k in ks:
        hit = ranks <= k
        out[f"recall@{k}"] = hit.float().mean()
        out[f"ndcg@{k}"] = torch.where(
            hit, 1.0 / torch.log2(ranks.float() + 1.0),
            torch.zeros((), device=ranks.device)).mean()
    return out


def top_k_items(user_emb: torch.Tensor, catalog_emb: torch.Tensor,
                k: int = 10,
                normalize: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain retrieval: cosine scores for the whole catalog, then the top k
    by a stable descending sort (ties -> lower index)."""
    u = l2_normalize(user_emb.float()) if normalize else user_emb.float()
    c = l2_normalize(catalog_emb.float()) if normalize else catalog_emb.float()
    scores = u @ c.T
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def inverse_norms(x: torch.Tensor) -> torch.Tensor:
    """1 / max(|x_i|, 1e-12) of each row, the scale the kernels fold in."""
    return 1.0 / torch.linalg.vector_norm(x, dim=-1).clamp_min(NORM_EPS)


def folded_scores(user_emb: torch.Tensor, catalog_emb: torch.Tensor,
                  normalize: bool = True) -> torch.Tensor:
    """K2's scores as the kernel computes them, in plain PyTorch: the raw
    dot products, each scaled by its user's and then its row's inverse norm,
    ``((u . c) * inv(u)) * inv(c)``; with ``normalize=False`` the dots."""
    u, c = user_emb.float(), catalog_emb.float()
    dots = u @ c.T
    if not normalize:
        return dots
    return dots * inverse_norms(u)[:, None] * inverse_norms(c)[None, :]


@dataclass(frozen=True)
class RetrievalPlan:
    """How K2 and B11 cut one call: ``shares`` contiguous shares of
    ``rows_per_share`` catalog rows, one CTA each (the last may be shorter,
    none is empty); the users in ``groups`` groups of ``users_per_group``;
    each share streamed as stages (tile of ``tile_rows`` rows, a multiple of
    32 up to ``TILE_ROWS``, user group, chunk of ``chunk`` columns), groups
    inside tiles, so that a tile's rows cross HBM once."""

    users: int
    rows: int
    width: int
    chunk: int
    users_per_group: int
    groups: int
    shares: int
    rows_per_share: int
    tile_rows: int

    def share_rows(self, share: int) -> range:
        start = share * self.rows_per_share
        return range(start, min(self.rows, start + self.rows_per_share))

    def tiles(self, share: int) -> List[range]:
        rows = self.share_rows(share)
        return [range(t, min(rows.stop, t + self.tile_rows))
                for t in range(rows.start, rows.stop, self.tile_rows)]

    def group_users(self, group: int) -> range:
        start = group * self.users_per_group
        return range(start, min(self.users, start + self.users_per_group))

    def chunks(self) -> List[range]:
        return [range(c, min(self.width, c + self.chunk))
                for c in range(0, self.width, self.chunk)]

    def stages(self, share: int) -> List[Tuple[range, range, range]]:
        """The share's stream in the kernel's order: (rows, users, columns)."""
        return [(t, self.group_users(g), c) for t in self.tiles(share)
                for g in range(self.groups) for c in self.chunks()]


def retrieval_plan(b: int, n: int, d: int, elem_bytes: int,
                   sm_count: int) -> RetrievalPlan:
    """The partition of a call over ``b`` users and an ``[n, d]`` catalog of
    ``elem_bytes``-byte elements on a card of ``sm_count`` SMs: the smallest
    user group that holds every user (up to 64, then groups of 64), one
    share per SM but no more shares than ``n / MIN_SHARE_ROWS`` rounded
    up, and a share's fewest tiles of equal size in whole row slots (152
    rows: 96 + 56, so that no tile is a short tail whose stages stream at
    the ring's latency)."""
    if min(b, n, d, sm_count) < 1 or elem_bytes not in CHUNK:
        raise ValueError(f"no retrieval plan for b={b} n={n} d={d} "
                         f"elem_bytes={elem_bytes} sm_count={sm_count}")
    ug = next((g for g in USER_GROUPS if b <= g), USER_GROUPS[-1])
    shares = max(1, min(sm_count, -(-n // MIN_SHARE_ROWS)))
    rows_per_share = -(-n // shares)
    per_tile = -(-rows_per_share // -(-rows_per_share // TILE_ROWS))
    tile_rows = min(TILE_ROWS, -(-per_tile // 32) * 32)
    return RetrievalPlan(users=b, rows=n, width=d, chunk=CHUNK[elem_bytes],
                         users_per_group=ug, groups=-(-b // ug),
                         shares=-(-n // rows_per_share),
                         rows_per_share=rows_per_share, tile_rows=tile_rows)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The SM count of a CUDA device, asked once per device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with a 16-byte aligned base (a view from a slice can
    start anywhere: it is copied)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def kernel_inputs(user_emb: torch.Tensor, catalog: torch.Tensor,
                  k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The checks and layout both retrieval kernels need: float32 users
    ``[B, D]`` against a catalog ``[N, D]``, 1 <= k <= N, both contiguous
    and 16-byte aligned.  Any width D >= 1."""
    u = aligned(user_emb.float())
    c = aligned(catalog)
    if u.dim() != 2 or c.dim() != 2 or u.shape[1] != c.shape[1]:
        raise ValueError(f"bad shapes users {tuple(u.shape)} "
                         f"catalog {tuple(c.shape)}")
    if u.shape[0] < 1 or u.shape[1] < 1:
        raise ValueError(f"empty users {tuple(u.shape)}")
    n = c.shape[0]
    if not 1 <= k <= min(n, MAX_KERNEL_K):
        raise ValueError(f"k must be in [1, {min(n, MAX_KERNEL_K)}], got {k}")
    return u, c


def kernel_outputs(plan: RetrievalPlan, k: int, device: torch.device):
    """The shares' lists (scores and ids, both 32-bit, in one allocation)
    and the outputs: scores [B, k] float32, ids [B, k] int64."""
    part = torch.empty(2, plan.users, plan.shares, k, device=device,
                       dtype=torch.int32)
    return (part, torch.empty(plan.users, k, device=device),
            torch.empty(plan.users, k, device=device, dtype=torch.int64))


def retrieve_top_k(user_emb: torch.Tensor, catalog_emb: torch.Tensor,
                   k: int = 10,
                   normalize: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k catalog items per user: K2 for CUDA tensors, ``top_k_items``
    for CPU tensors.  The kernel normalises in its epilogue
    (``folded_scores``): nothing else is launched.

    ``k > 32`` takes ``top_k_items`` on every device: that is the JAX
    package's own dispatch rule (its in-kernel selection is k unrolled
    rounds, the wrong tool beyond serving-size k).  On a CUDA tensor with
    k <= 32 it launches the kernel or raises.
    """
    if user_emb.device.type == "cpu" or k > MAX_KERNEL_K:
        return top_k_items(user_emb, catalog_emb, k, normalize)
    if user_emb.device.type != "cuda" or catalog_emb.device != user_emb.device:
        raise ValueError("users and catalog must be on one CUDA device")
    return launch_k2(user_emb, catalog_emb, k, normalize)


def launch_k2(user_emb: torch.Tensor, catalog_emb: torch.Tensor, k: int,
              normalize: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's launches (the share pass and the merge) on checked inputs; the
    device test is ``retrieve_top_k``'s."""
    u, c = kernel_inputs(user_emb, catalog_emb.float(), k)
    (b, d), n = u.shape, c.shape[0]
    plan = retrieval_plan(b, n, d, 4, sm_count(u.device))
    part, out_s, out_i = kernel_outputs(plan, k, u.device)
    err = load_kernels().lib.unirec_retrieve_topk(
        u.data_ptr(), c.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(), b, n, d, k, int(normalize),
        plan.users_per_group, plan.shares, plan.rows_per_share,
        plan.tile_rows, torch.cuda.current_stream(u.device).cuda_stream,
    )
    check(err, "retrieve_topk")
    retrieve_top_k.launches += 1
    return out_s, out_i


retrieve_top_k.launches = 0
