"""The port's sequence-parallel cross-attention
(``unirec_tpu_torch/ops/sharded_attention.py``) against the JAX op
``unirec_tpu.ops.sharded_attention.sequence_parallel_cross_attention`` on a
mesh of the virtual CPU devices, with four gloo ranks
(``tests/torch_dist_ranks.py``) spawned once for the module.

* the combine at 2 and 4 shards, atol 2e-5 (the JAX test's), also against
  unsharded attention;
* a batch whose second half of the memory is masked: at 2 shards one shard
  is all masked, and the output stays finite and equal;
* q's, k's and v's gradients of sum(out * ct) at 2 shards against
  ``jax.grad`` of the JAX op, within 1e-5: each rank scales its loss by
  1/S, the combine's backward all-reduces the cotangent, and q's gradient
  is summed over the group (``train/common.reduce_step``'s rule);
* a memory length that does not divide raises "not divisible".
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_dist_ranks as ranks
from tests.torch_dist_ranks import one_torch_thread  # noqa: F401
from unirec_tpu.configs import MeshConfig
from unirec_tpu.ops.attention import attention, make_additive_mask
from unirec_tpu.ops.sharded_attention import (
    sequence_parallel_cross_attention as jax_sp_attention,
)
from unirec_tpu.parallel.mesh import make_mesh
from unirec_tpu_torch.ops.sharded_attention import split_memory


B, H, LQ, LKV, HD = 2, 4, 8, 64, 16


def _case(seed, masked_half):
    rng = np.random.RandomState(seed)
    mask = (rng.rand(B, LKV) > 0.3).astype(np.float32)
    if masked_half:
        mask[:, LKV // 2:] = 0.0  # at 2 shards, shard 1 is all masked
    return {"q": rng.randn(B, H, LQ, HD).astype(np.float32),
            "k": rng.randn(B, H, LKV, HD).astype(np.float32),
            "v": rng.randn(B, H, LKV, HD).astype(np.float32),
            "bias": np.asarray(make_additive_mask(jnp.asarray(mask))),
            "ct": rng.randn(B, H, LQ, HD).astype(np.float32)}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("sharded"))
    cases = {"random": _case(0, False), "masked_half": _case(1, True)}
    torch.save(cases, os.path.join(work, "sharded.inputs.pt"))
    procs = ranks.start_group("sharded", 4, work)
    want = {}
    for name, c in cases.items():
        q, k, v, bias, ct = (jnp.asarray(c[x])
                             for x in ("q", "k", "v", "bias", "ct"))
        want[(name, "plain")] = np.asarray(attention(q, k, v, bias))
        for shards in (2, 4):
            mesh = make_mesh(MeshConfig(dp=8 // shards, tp=shards))

            def loss(q, k, v):
                o = jax_sp_attention(q, k, v, bias, mesh=mesh, axis="tp")
                return jnp.sum(o * ct), o

            (_, o), g = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
            want[(name, shards)] = {"out": np.asarray(o),
                                    **{d: np.asarray(x) for d, x in
                                       zip(("dq", "dk", "dv"), g)}}
    return cases, want, ranks.finish_group("sharded", procs, work)


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("name", ["random", "masked_half"])
def test_combine_matches_jax(results, name, shards):
    _, want, got = results
    for r in got:
        out = r[(name, shards)]["out"].numpy()
        assert np.isfinite(out).all()
        np.testing.assert_allclose(out, want[(name, shards)]["out"],
                                   atol=2e-5, rtol=0)
        np.testing.assert_allclose(out, want[(name, "plain")], atol=2e-5,
                                   rtol=0)


@pytest.mark.parametrize("name", ["random", "masked_half"])
def test_gradients_match_jax_grad(results, name):
    """At 2 shards: q's gradient (summed over the pair) on every rank, and
    the k / v slices' gradients concatenated over the pair."""
    _, want, got = results
    w = want[(name, 2)]
    for pair in ((0, 1), (2, 3)):
        for r in pair:
            np.testing.assert_allclose(got[r][(name, 2)]["dq"].numpy(),
                                       w["dq"], atol=1e-5, rtol=0)
        for d in ("dk", "dv"):
            whole = np.concatenate([got[r][(name, 2)][d].numpy()
                                    for r in pair], axis=2)
            np.testing.assert_allclose(whole, w[d], atol=1e-5, rtol=0)
    if name == "masked_half":  # the all-masked slice takes no gradient
        for d in ("dk", "dv"):
            assert not got[1][(name, 2)][d].abs().any()


def test_indivisible_length_raises(results):
    """The JAX op's refusal; the port's is the split of the memory."""
    _, _, got = results
    for r in got:
        assert r["indivisible"] == "memory length 15 not divisible by 2"
    mesh = make_mesh(MeshConfig(dp=4, tp=2))
    q, k = jnp.zeros((1, 2, 4, 8)), jnp.zeros((1, 2, 15, 8))
    with pytest.raises(ValueError, match="memory length 15 not divisible "
                                         "by 2"):
        jax_sp_attention(q, k, k, mesh=mesh, axis="tp")
    with pytest.raises(ValueError, match="not divisible"):
        split_memory(torch.zeros(1, 15, 8), 2, 0)
