"""Port parity: int8 catalog quantization and int8 retrieval (B11's plain
path), unirec_tpu_torch vs unirec_tpu on the CPU.

``retrieve_top_k_int8`` is held to the JAX function run with
``interpret=True`` (the Pallas kernel for k <= 32, the XLA path above):
catalog ids identical, scores within 1e-5.  ``quantize_rows`` divides by the
L2 norm, which both sides sum in their own order, so codes may differ where
a quotient sits within an ulp of a rounding boundary: the test allows none on
its fixture.  A norm one ulp off moves the row's absmax by an ulp, and its
scale (absmax / 127) by up to two.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_dist_ranks import one_torch_thread  # noqa: F401
from unirec_tpu.ops import quantization as jq
from unirec_tpu_torch.ops import quantization as pq


N, DIM, USERS = 300, 64, 7


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    catalog = rng.randn(N, DIM).astype(np.float32) * rng.uniform(
        0.1, 5.0, (N, 1)).astype(np.float32)
    catalog[17] = catalog[40]  # a tie: equal rows score equally
    users = rng.randn(USERS, DIM).astype(np.float32)
    return catalog, users


def test_quantize_rows_matches_jax(data):
    catalog, _ = data
    jcodes, jscales = jq.quantize_rows(jnp.asarray(catalog))
    codes, scales = pq.quantize_rows(torch.from_numpy(catalog))
    assert codes.dtype == torch.int8 and scales.dtype == torch.float32
    assert codes.shape == (N, DIM) and scales.shape == (N,)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_max_ulp(scales.numpy(), np.asarray(jscales),
                                    maxulp=2)
    assert np.abs(codes.numpy()).max(axis=1).min() == 127
    deq = pq.dequantize_rows(codes, scales).numpy()
    np.testing.assert_allclose(deq, np.asarray(jq.dequantize_rows(
        jcodes, jscales)), rtol=6e-7, atol=0)  # equal codes x scales


def test_quantized_scores_match_jax(data):
    catalog, users = data
    jcodes, jscales = jq.quantize_rows(jnp.asarray(catalog))
    want = np.asarray(jq.quantized_scores(jnp.asarray(users), jcodes,
                                          jscales))
    got = pq.quantized_scores(torch.from_numpy(users),
                              torch.from_numpy(np.array(jcodes)),
                              torch.from_numpy(np.array(jscales)))
    assert got.shape == (USERS, N)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("k", [1, 10, 32, 40])
def test_retrieve_top_k_int8_matches_jax(data, k):
    catalog, users = data
    jcodes, jscales = jq.quantize_rows(jnp.asarray(catalog))
    ws, wi = jq.retrieve_top_k_int8(jnp.asarray(users), jcodes, jscales, k=k,
                                    block_n=128, interpret=True)
    pq.retrieve_top_k_int8.launches = 0
    gs, gi = pq.retrieve_top_k_int8(torch.from_numpy(users),
                                    torch.from_numpy(np.array(jcodes)),
                                    torch.from_numpy(np.array(jscales)),
                                    k=k)
    assert pq.retrieve_top_k_int8.launches == 0  # CPU: the plain path
    assert gs.shape == gi.shape == (USERS, k) and gi.dtype == torch.int64
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=1e-5, rtol=0)
    assert (np.diff(gs.numpy(), axis=1) <= 0).all()


def test_ties_go_to_the_lower_index(data):
    catalog, _ = data
    codes, scales = pq.quantize_rows(torch.from_numpy(catalog))
    user = torch.from_numpy(catalog[40:41].copy())  # rows 17 and 40 tie
    s, i = pq.retrieve_top_k_int8(user, codes, scales, k=2)
    assert i[0].tolist() == [17, 40] and s[0, 0] == s[0, 1]


def test_retrieve_top_k_int8_refuses_other_devices():
    u = torch.empty(2, DIM, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pq.retrieve_top_k_int8(u, torch.empty(N, DIM, dtype=torch.int8,
                                              device="meta"),
                               torch.empty(N, device="meta"), k=5)
