"""The trainable fused Q-Former blocks B12s / B12c of the port against the JAX
package's Pallas kernels in interpret mode: forward values and the gradients
of every input, through ``torch.autograd`` and ``jax.value_and_grad``, in
float32 at the JAX test's tolerances (``tests/test_fused_train.py``); the
shape gate; and the tiny Item Q-Former with ``fused_training`` against JAX's.

The port's weights are the torch ``Linear`` layout ``[out, in]``; the JAX
functions take ``[in, out]`` kernels, so the tests transpose.

The two block comparisons hold the forward elementwise at rtol 1e-5, which
an isolated run meets with 16x to spare (worst |port - JAX| 6.2% of the
tolerance).  Each case computes both sides in one fresh interpreter
(``isolated``, a spawned worker process shared by the module), so that no
process-wide state left by another test file in the same pytest worker
(thread pools, matmul precision, floating-point modes, caches) reaches
either side; the checks run here on what it returns.
"""

import dataclasses
import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unirec_tpu.configs import ItemQFormerConfig
from unirec_tpu.models.item_qformer import ItemQFormer as JaxItemQFormer
from unirec_tpu.ops import fused_qformer_vjp as jvjp
from unirec_tpu_torch.models.item_qformer import ItemQFormer
from unirec_tpu_torch.ops import _build
from unirec_tpu_torch.ops import fused_qformer_vjp as pvjp
from unirec_tpu_torch.utils.weights import (
    flax_to_state_dict,
    item_qformer_state_dict_from_flax,
)

HEADS, D = 4, 128  # head_dim 32


def _weights(rng, dm, d):
    return dict(
        wq=rng.randn(d, d) * 0.05, bq=rng.randn(d) * 0.01,
        wkv=rng.randn(dm, 2 * d) * 0.05, bkv=rng.randn(2 * d) * 0.01,
        wqkv=rng.randn(d, 3 * d) * 0.05, bqkv=rng.randn(3 * d) * 0.01,
        wo=rng.randn(d, d) * 0.05, bo=rng.randn(d) * 0.01)


def _torch_args(arrays, transpose):
    """numpy -> float32 leaf tensors needing grad; kernels [in, out] become
    torch weights [out, in]."""
    return [torch.tensor(a.T if t else a, dtype=torch.float32,
                         requires_grad=True)
            for a, t in zip(arrays, transpose)]


def _check_value(out, loss, jout, jv, ct):
    """The forward elementwise at the JAX test's rtol 1e-5, and the loss
    (a sum of thousands of signed terms, summed in another order by each
    framework) at 1e-5 of the sum of their magnitudes."""
    np.testing.assert_allclose(out, jout, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(loss, jv, rtol=1e-5,
                               atol=1e-5 * float(np.abs(jout * ct).sum()))


def _check_grads(port_grads, jax_grads, names, transpose):
    for g, want, name, t in zip(port_grads, jax_grads, names, transpose):
        np.testing.assert_allclose(g.T if t else g, want, atol=2e-4, rtol=1e-4,
                                   err_msg=name)


@pytest.fixture(scope="module")
def isolated():
    """Runs a case function in a fresh spawned interpreter (one for the
    module) and returns its numpy results."""
    with ProcessPoolExecutor(
            max_workers=1,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        yield lambda fn, *args: pool.submit(fn, *args).result()


def _self_case(b, k):
    """The self block on both sides: (out, loss, jout, jv, ct, port grads,
    JAX grads) as numpy."""
    rng = np.random.RandomState(0)
    w = _weights(rng, D, D)
    x = rng.randn(b, k, D).astype(np.float32)
    kbias = np.zeros((b, k), np.float32)
    ct = rng.randn(b, k, D).astype(np.float32)
    arrays = [x, w["wqkv"], w["bqkv"], w["wo"], w["bo"]]
    transpose = [False, True, False, True, False]

    def jloss(*a):
        out = jvjp.fused_self_attention_train(
            a[0], jnp.asarray(kbias), *a[1:], num_heads=HEADS, interpret=True)
        return jnp.sum(out * ct), out

    (jv, jout), jg = jax.value_and_grad(jloss, argnums=tuple(range(5)),
                                        has_aux=True)(
        *[jnp.asarray(a, jnp.float32) for a in arrays])
    targs = _torch_args(arrays, transpose)
    out = pvjp.fused_self_attention_train(targs[0], torch.tensor(kbias),
                                          *targs[1:], num_heads=HEADS)
    loss = (out * torch.tensor(ct)).sum()
    loss.backward()
    return _as_numpy(out, loss, jout, jv, ct, targs, jg)


def _as_numpy(out, loss, jout, jv, ct, targs, jg):
    return (out.detach().numpy(), float(loss.detach()), np.asarray(jout),
            float(jv), ct, [t.grad.numpy() for t in targs],
            [np.asarray(g) for g in jg])


@pytest.mark.parametrize("b,k", [(8, 32), (5, 32), (16, 8), (7, 8)],
                         ids=["full_tiles", "ragged_rows", "k8", "k8_ragged"])
def test_self_block_matches_jax(isolated, b, k):
    out, loss, jout, jv, ct, grads, jg = isolated(_self_case, b, k)
    _check_value(out, loss, jout, jv, ct)
    _check_grads(grads, jg, ["x", "wqkv", "bqkv", "wo", "bo"],
                 [False, True, False, True, False])


def _cross_case(b, k, f):
    """The cross block on both sides, as ``_self_case``."""
    rng = np.random.RandomState(1)
    dm = 96
    w = _weights(rng, dm, D)
    x = rng.randn(b, k, D).astype(np.float32)
    mem = rng.randn(b, f, dm).astype(np.float32)
    mask = (rng.rand(b, f) > 0.3).astype(np.float32)
    mask[0] = 0.0  # an item with no valid field
    kbias = ((1.0 - mask) * jvjp.NEG_INF).astype(np.float32)
    ct = rng.randn(b, k, D).astype(np.float32)
    arrays = [x, mem, w["wq"], w["bq"], w["wkv"], w["bkv"], w["wo"], w["bo"]]
    transpose = [False, False, True, False, True, False, True, False]

    def jloss(*a):
        out = jvjp.fused_cross_attention_train(
            a[0], a[1], jnp.asarray(kbias), *a[2:], num_heads=HEADS,
            interpret=True)
        return jnp.sum(out * ct), out

    (jv, jout), jg = jax.value_and_grad(jloss, argnums=tuple(range(8)),
                                        has_aux=True)(
        *[jnp.asarray(a, jnp.float32) for a in arrays])
    targs = _torch_args(arrays, transpose)
    out = pvjp.fused_cross_attention_train(targs[0], targs[1],
                                           torch.tensor(kbias), *targs[2:],
                                           num_heads=HEADS)
    loss = (out * torch.tensor(ct)).sum()
    loss.backward()
    return _as_numpy(out, loss, jout, jv, ct, targs, jg)


@pytest.mark.parametrize("b,k,f", [(9, 32, 14), (3, 32, 7), (13, 8, 5)],
                         ids=["masks", "few_fields", "k8_ragged_batch"])
def test_cross_block_matches_jax(isolated, b, k, f):
    out, loss, jout, jv, ct, grads, jg = isolated(_cross_case, b, k, f)
    _check_value(out, loss, jout, jv, ct)
    _check_grads(grads, jg, ["x", "mem", "wq", "bq", "wkv", "bkv", "wo", "bo"],
                 [False, False, True, False, True, False, True, False])


def test_kernel_functions_match_jax_forward_residuals():
    """The B12 forward wrappers' saved residuals (qkv / q, kv, ctx) and the
    backward wrappers' outputs against the JAX kernels' own, on the CPU (the
    plain versions; no launch counted, nothing built)."""
    rng = np.random.RandomState(2)
    b, k, f, dm = 32, 8, 6, 64  # one whole 256-row tile of the JAX kernels
    w = _weights(rng, dm, D)
    x2 = rng.randn(b * k, D).astype(np.float32)
    mem2 = rng.randn(b * f, dm).astype(np.float32)
    mask = (rng.rand(b * f) > 0.3).astype(np.float32)
    kb = ((1.0 - mask) * jvjp.NEG_INF).astype(np.float32)
    dout = rng.randn(b * k, D).astype(np.float32)
    t = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    for fn in (pvjp.self_attention_fwd, pvjp.self_attention_bwd,
               pvjp.cross_attention_fwd, pvjp.cross_attention_bwd):
        fn.launches = 0

    zeros = np.zeros(b * k, np.float32)
    j_self = jvjp._self_fwd(jnp.asarray(x2), jnp.asarray(zeros),
                            *(jnp.asarray(w[n], jnp.float32)
                              for n in ("wqkv", "bqkv", "wo", "bo")),
                            HEADS, k, True)
    p_self = pvjp.self_attention_fwd(t(x2), t(zeros), t(w["wqkv"].T),
                                     t(w["bqkv"]), t(w["wo"].T), t(w["bo"]),
                                     num_heads=HEADS, n_q=k)
    for got, want in zip(p_self, j_self):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=2e-5, rtol=1e-5)
    j_dqkv = jvjp._self_bwd_call(j_self[1], jnp.asarray(w["wo"], jnp.float32),
                                 jnp.asarray(zeros), jnp.asarray(dout), HEADS, k,
                                 True)
    p_dqkv = pvjp.self_attention_bwd(p_self[1], t(w["wo"].T), t(zeros), t(dout),
                                     num_heads=HEADS, n_q=k)
    np.testing.assert_allclose(p_dqkv.numpy(), np.asarray(j_dqkv), atol=2e-5,
                               rtol=1e-4)

    j_cross = jvjp._cross_fwd(jnp.asarray(x2), jnp.asarray(mem2),
                              jnp.asarray(kb),
                              *(jnp.asarray(w[n], jnp.float32)
                                for n in ("wq", "bq", "wkv", "bkv", "wo", "bo")),
                              HEADS, k, f, True)
    p_cross = pvjp.cross_attention_fwd(
        t(x2), t(mem2), t(kb), t(w["wq"].T), t(w["bq"]), t(w["wkv"].T),
        t(w["bkv"]), t(w["wo"].T), t(w["bo"]), num_heads=HEADS, n_q=k, n_kv=f)
    for got, want in zip(p_cross, j_cross):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                                   rtol=1e-5)
    j_dq, j_dkv = jvjp._cross_bwd_call(j_cross[1], j_cross[2],
                                       jnp.asarray(w["wo"], jnp.float32),
                                       jnp.asarray(kb), jnp.asarray(dout),
                                       HEADS, k, f, True)
    p_dq, p_dkv = pvjp.cross_attention_bwd(p_cross[1], p_cross[2],
                                           t(w["wo"].T), t(kb), t(dout),
                                           num_heads=HEADS, n_q=k, n_kv=f)
    np.testing.assert_allclose(p_dq.numpy(), np.asarray(j_dq), atol=2e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(p_dkv.numpy(), np.asarray(j_dkv), atol=2e-5,
                               rtol=1e-4)
    for fn in (pvjp.self_attention_fwd, pvjp.self_attention_bwd,
               pvjp.cross_attention_fwd, pvjp.cross_attention_bwd):
        assert fn.launches == 0, fn.__name__
    assert _build.load_kernels.cache_info().currsize == 0


def test_bf16_plain_versions_round_where_jax_does():
    """In bfloat16 the plain versions round at the JAX kernels' points: the
    residuals equal the JAX kernels' bf16 outputs up to one-ulp flips of
    differently ordered fp32 sums."""
    rng = np.random.RandomState(3)
    b, k, f = 32, 8, 5  # one whole 256-row tile of the JAX kernels
    w = _weights(rng, D, D)
    x2 = rng.randn(b * k, D).astype(np.float32)
    mem2 = rng.randn(b * f, D).astype(np.float32)
    kb = np.zeros(b * f, np.float32)
    kb[:f] = jvjp.NEG_INF  # item 0 has no field
    bf = lambda a: torch.tensor(a, dtype=torch.float32).bfloat16()  # noqa: E731
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    j_out = jvjp._cross_fwd(jb(x2), jb(mem2), jnp.asarray(kb),
                            *(jb(w[n]) for n in ("wq", "bq", "wkv", "bkv", "wo",
                                                 "bo")), HEADS, k, f, True)
    p_out = pvjp.cross_attention_fwd(
        bf(x2), bf(mem2), torch.tensor(kb), bf(w["wq"].T), bf(w["bq"]),
        bf(w["wkv"].T), bf(w["bkv"]), bf(w["wo"].T), bf(w["bo"]),
        num_heads=HEADS, n_q=k, n_kv=f)
    for got, want in zip(p_out, j_out):
        want = np.asarray(want.astype(jnp.float32))
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2,
                                   rtol=1e-2)


def test_supports_fused_train_matches_jax():
    for k in (1, 2, 3, 8, 16, 32, 33, 64, 128, 256, 512):
        for d, h in ((128, 4), (1000, 16), (1024, 16), (1152, 16), (2048, 16)):
            for f in (1, 14, 100, 1600):
                assert pvjp.supports_fused_train(k, d, h, f) == \
                    jvjp.supports_fused_train(k, d, h, f), (k, d, h, f)
    # shapes the old kernels refused and the new ones take on the card (C-7,
    # C-10; held there by test_b12_takes_every_admitted_shape), admitted by
    # both gates: K = F = 128 at head dim 128, one head of 1024, hidden 1020
    for k, d, h, f in ((128, 1024, 8, 128), (64, 1024, 1, 64),
                       (32, 1020, 4, 14)):
        assert pvjp.supports_fused_train(k, d, h, f)
        assert jvjp.supports_fused_train(k, d, h, f)


@pytest.mark.parametrize("d,heads", [(512, 2), (512, 1), (1020, 4)],
                         ids=["hd256", "hd512", "d1020"])
def test_kernel_functions_take_wide_heads(d, heads):
    """B12's plain versions at shapes the kernels newly take (C-7, C-10): K
    = F = 8 over 32 items (one whole 256-row tile of the JAX kernels; one
    item without a field) at 2 heads of 256, one head of 512 and hidden
    1020 in 4 heads, forward residuals and backward outputs against the JAX
    kernels in interpret mode, in float32."""
    rng = np.random.RandomState(4)
    b, k, f = 32, 8, 8
    s = d ** -0.5
    w = {n: rng.randn(*shape).astype(np.float32) * (s if len(shape) > 1
                                                      else 0.01)
         for n, shape in (("wq", (d, d)), ("bq", (d,)), ("wkv", (d, 2 * d)),
                          ("bkv", (2 * d,)), ("wqkv", (d, 3 * d)),
                          ("bqkv", (3 * d,)), ("wo", (d, d)), ("bo", (d,)))}
    x2 = rng.randn(b * k, d).astype(np.float32)
    mem2 = rng.randn(b * f, d).astype(np.float32)
    mask = (rng.rand(b, f) > 0.3).astype(np.float32)
    mask[1] = 0.0
    kb = ((1.0 - mask) * jvjp.NEG_INF).astype(np.float32).reshape(-1)
    dout = rng.randn(b * k, d).astype(np.float32)
    zeros = np.zeros(b * k, np.float32)
    t = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    j = lambda n: jnp.asarray(w[n], jnp.float32)  # noqa: E731
    close = lambda got, want: np.testing.assert_allclose(  # noqa: E731
        got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)

    j_self = jvjp._self_fwd(jnp.asarray(x2), jnp.asarray(zeros), j("wqkv"),
                            j("bqkv"), j("wo"), j("bo"), heads, k, True)
    p_self = pvjp.self_attention_fwd(t(x2), t(zeros), t(w["wqkv"].T),
                                     t(w["bqkv"]), t(w["wo"].T), t(w["bo"]),
                                     num_heads=heads, n_q=k)
    for got, want in zip(p_self, j_self):
        close(got, want)
    close(pvjp.self_attention_bwd(p_self[1], t(w["wo"].T), t(zeros), t(dout),
                                  num_heads=heads, n_q=k),
          jvjp._self_bwd_call(j_self[1], j("wo"), jnp.asarray(zeros),
                              jnp.asarray(dout), heads, k, True))

    j_cross = jvjp._cross_fwd(jnp.asarray(x2), jnp.asarray(mem2),
                              jnp.asarray(kb), j("wq"), j("bq"), j("wkv"),
                              j("bkv"), j("wo"), j("bo"), heads, k, f, True)
    p_cross = pvjp.cross_attention_fwd(
        t(x2), t(mem2), t(kb), t(w["wq"].T), t(w["bq"]), t(w["wkv"].T),
        t(w["bkv"]), t(w["wo"].T), t(w["bo"]), num_heads=heads, n_q=k, n_kv=f)
    for got, want in zip(p_cross, j_cross):
        close(got, want)
    j_grads = jvjp._cross_bwd_call(j_cross[1], j_cross[2], j("wo"),
                                   jnp.asarray(kb), jnp.asarray(dout), heads,
                                   k, f, True)
    p_grads = pvjp.cross_attention_bwd(p_cross[1], p_cross[2], t(w["wo"].T),
                                       t(kb), t(dout), num_heads=heads, n_q=k,
                                       n_kv=f)
    for got, want in zip(p_grads, j_grads):
        close(got, want)


def test_item_qformer_fused_training_matches_jax():
    """A tiny ``ItemQFormer(fused_training=True)``: the training forward and
    every parameter's gradient against the JAX model's with the same weights
    (dropout 0; JAX runs its Pallas blocks in interpret mode), and against
    the port's own plain path."""
    cfg = ItemQFormerConfig(
        hidden_size=D, num_hidden_layers=3, num_attention_heads=HEADS,
        intermediate_size=256, num_query_tokens=32, field_embedding_dim=D,
        num_fields=5, dropout=0.0, fused_training=True)
    rng = np.random.RandomState(3)
    fields = rng.randn(6, 5, D).astype(np.float32)
    mask = (rng.rand(6, 5) > 0.3).astype(np.float32)
    mask[1] = 0.0
    jm = JaxItemQFormer(cfg)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(fields),
                     jnp.asarray(mask))

    def jloss(p):
        out = jm.apply(p, jnp.asarray(fields), jnp.asarray(mask),
                       deterministic=False,
                       rngs={"dropout": jax.random.PRNGKey(9)})
        return (jnp.mean(out["query_outputs"] ** 2)
                + jnp.mean(out["reconstructed_fields"] ** 2))

    jv, jg = jax.value_and_grad(jloss)(params)
    want = flax_to_state_dict(jg)
    sd = item_qformer_state_dict_from_flax(params)

    from unirec_tpu_torch.ops.dropout import DropoutStream

    for fused in (True, False):
        model = ItemQFormer(dataclasses.replace(cfg, fused_training=fused))
        model.load_state_dict(sd)
        model.train()
        out = model(torch.tensor(fields), torch.tensor(mask),
                    dropout=DropoutStream(0, 0))
        loss = (out["query_outputs"].square().mean()
                + out["reconstructed_fields"].square().mean())
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(jv), rtol=1e-5)
        for name, p in model.named_parameters():
            # the item head feeds no term of this loss: JAX's zero gradient
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                       atol=3e-4, rtol=2e-4, err_msg=name)


def test_model_dispatch_takes_the_fused_blocks(monkeypatch):
    """The fused branch is taken for a key-only bias with prob dropout off,
    on the CPU in any dtype (as JAX takes interpret mode), and not when
    ``fused_training`` is off or attention-prob dropout is active."""
    seen = []
    real_self, real_cross = pvjp._SelfBlock.apply, pvjp._CrossBlock.apply
    monkeypatch.setattr(pvjp._SelfBlock, "apply",
                        lambda *a: seen.append("self") or real_self(*a))
    monkeypatch.setattr(pvjp._CrossBlock, "apply",
                        lambda *a: seen.append("cross") or real_cross(*a))
    from unirec_tpu_torch.configs import QFormerConfig
    from unirec_tpu_torch.models.qformer import QFormerModel
    from unirec_tpu_torch.ops.dropout import DropoutStream

    base = QFormerConfig(hidden_size=64, num_hidden_layers=2,
                         num_attention_heads=4, intermediate_size=128,
                         encoder_width=64, hidden_dropout_prob=0.1,
                         attention_probs_dropout_prob=0.0)
    x, mem = torch.randn(3, 8, 64), torch.randn(3, 5, 64)
    for cfg, want in ((dataclasses.replace(base, fused_training=True),
                       ["self", "cross", "self"]),
                      (base, []),
                      (dataclasses.replace(base, fused_training=True,
                                           attention_probs_dropout_prob=0.1),
                       [])):
        seen.clear()
        QFormerModel(cfg)(x, None, mem, torch.ones(3, 5),
                          dropout=DropoutStream(0, 0))
        assert seen == want, (cfg, seen)
    # a deterministic forward of a fused_training config takes them too
    seen.clear()
    QFormerModel(dataclasses.replace(base, fused_training=True,
                                     attention_probs_dropout_prob=0.1))(
        x, None, mem, torch.ones(3, 5))
    assert seen == ["self", "cross", "self"]
