"""Port parity: K2's plain version (ops/ranking.top_k_items, which the CPU
wrapper runs) vs the JAX blocked retrieval kernel in interpret mode
(``block_u=8, block_n=128``), on the CPU.  Ids must match exactly; scores
within 1e-6.

Cases: a catalog that is not a multiple of the block (padded rows must score
-inf, not 0), all-negative scores, exact ties (-> lower index), k=20.

The kernels' folded score (``folded_scores``: raw dot products scaled by the
user's and the row's inverse norms) is held to ``top_k_items`` and to the JAX
kernel on the same cases and on rows of norms from 1e-6 to 1e6 with a zero
row and a zero user: scores within 1e-6, ids equal except near-ties (plain
scores within 1e-6), zero rows scoring 0 on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_dist_ranks import one_torch_thread  # noqa: F401
from unirec_tpu.ops.ranking import retrieve_top_k as jax_retrieve
from unirec_tpu.ops.losses import l2_normalize as jax_l2
from unirec_tpu_torch.ops.losses import l2_normalize
from unirec_tpu_torch.ops.ranking import (
    folded_scores,
    retrieve_top_k,
    top_k_items,
)


def _case(name):
    rng = np.random.RandomState(7)
    if name == "padded_catalog":
        return rng.randn(10, 32), rng.randn(300, 32)
    if name == "all_negative":
        base = rng.randn(64)
        cat = -np.abs(rng.rand(290, 1)) * base[None, :]
        cat += rng.randn(290, 64) * 1e-3
        return np.tile(base, (4, 1)), cat
    if name == "exact_ties":
        cat = rng.randn(200, 16)
        cat[150] = cat[3]  # duplicates of strong rows, later in the catalog
        cat[77] = cat[3]
        cat[199] = cat[40]
        users = np.stack([cat[3], cat[40], rng.randn(16)])
        return users, cat
    if name == "norm_range":
        cat = rng.randn(257, 48) * np.logspace(-6, 6, 257)[
            rng.permutation(257)][:, None]
        cat[11] = 0.0
        cat[200] = cat[100] * 1e-3  # the same direction at another norm
        users = rng.randn(6, 48)
        users[1] = cat[100] * 1e4
        users[2] = 0.0
        return users, cat
    raise KeyError(name)


@pytest.mark.parametrize("case", ["padded_catalog", "all_negative",
                                  "exact_ties"])
def test_plain_matches_jax_kernel(case):
    users, cat = (a.astype(np.float32) for a in _case(case))
    k = 20
    s_ref, i_ref = jax_retrieve(jnp.asarray(users), jnp.asarray(cat), k=k,
                                block_u=8, block_n=128, interpret=True)
    s, i = retrieve_top_k(torch.from_numpy(users), torch.from_numpy(cat), k=k)
    assert i.dtype == torch.int64 and s.shape == (len(users), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=1e-6, rtol=0)
    assert np.isfinite(s.numpy()).all()


@pytest.mark.parametrize("case", ["padded_catalog", "all_negative",
                                  "exact_ties", "norm_range"])
def test_folded_scores_match_plain_and_jax(case):
    users, cat = (a.astype(np.float32) for a in _case(case))
    u, c = torch.from_numpy(users), torch.from_numpy(cat)
    k = 20
    folded = folded_scores(u, c)
    s, i = torch.sort(folded, dim=-1, descending=True, stable=True)
    s, i = s[:, :k], i[:, :k]
    plain = l2_normalize(u) @ l2_normalize(c).T  # top_k_items' scores
    jax_s, jax_i = jax_retrieve(jnp.asarray(users), jnp.asarray(cat), k=k,
                                block_u=8, block_n=128, interpret=True)
    for s_ref, i_ref in (top_k_items(u, c, k=k),
                         (torch.from_numpy(np.array(jax_s)),
                          torch.from_numpy(np.array(jax_i)).long())):
        np.testing.assert_allclose(s.numpy(), s_ref.numpy(), atol=1e-6,
                                   rtol=0)
        diff = i != i_ref
        assert ((plain.gather(1, i) - s_ref)[diff].abs() < 1e-6).all()
    zero_rows = np.flatnonzero(~cat.any(axis=1))
    zero_users = np.flatnonzero(~users.any(axis=1))
    for scores in (folded, plain):
        assert (scores[:, zero_rows] == 0).all()
        assert (scores[zero_users] == 0).all()


def test_ties_go_to_lower_index():
    _, cat = _case("exact_ties")
    cat = cat.astype(np.float32)
    s, i = top_k_items(torch.from_numpy(cat[[3]]), torch.from_numpy(cat), k=3)
    assert i[0].tolist() == [3, 77, 150]
    assert s[0, 0] == s[0, 1] == s[0, 2]


def test_large_k_and_cpu_counter():
    """k > 32 takes the plain path on every device (the JAX dispatch rule);
    CPU tensors never launch the kernel."""
    users, cat = (a.astype(np.float32) for a in _case("padded_catalog"))
    before = retrieve_top_k.launches
    s, i = retrieve_top_k(torch.from_numpy(users), torch.from_numpy(cat), k=40)
    s_ref, i_ref = jax_retrieve(jnp.asarray(users), jnp.asarray(cat), k=40)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=1e-6)
    assert retrieve_top_k.launches == before


def test_l2_normalize_matches_jax():
    x = np.random.RandomState(0).randn(5, 9).astype(np.float32)
    x[2] = 0.0  # clamped norm: zero rows stay zero
    np.testing.assert_allclose(l2_normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_l2(jnp.asarray(x))), atol=1e-7)
