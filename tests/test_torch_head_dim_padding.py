"""Head dims that are not a kernel instance (C-4, C-5): the zero-padding of
``ops/attention.padded_launch`` and the plain versions at those head dims.

The attention kernels are built for every multiple of 16 up to 128 and for
256 (``KERNEL_HEAD_DIMS``).  Any other head dim up to 256 runs zero-padded to
the next instance, and any head dim above 256 zero-padded to C = ceil(hd /
256) chunks of 256 (the chunked form, ``csrc/flash_chunked.cuh``), with the
softmax scale of the true head dim: zero lanes add exact zeros to every dot
product, so the scores, (m, l), the output and the gradients' true columns
do not move.  Without a card that is checked on the plain versions: each
runs on the padded tensors inside ``padded_launch`` (with the true head
dim's scale, as the wrappers pass it to the kernels), and the true columns
it returns are held to the unpadded plain version within 1e-6 relative, for
K1 / B7b, B13, B14 (merged heads) and B14p, at hd 8, 24, 200, 257 and 300
(257 and 300 at 2 chunks, 512 wide).  The packed item attention B15 pads
nothing: its kernels take every head dim as it is; at those head dims its
plain version is held to the JAX kernel.

The port's plain B13, B14p and K1 / B7b at hd 8, 24, 320 and 512 are held
to the JAX functions in interpret mode, as ``tests/test_torch_flash_cross.py``,
``tests/test_torch_flash_vjp.py`` and
``tests/test_torch_flash_causal_head_dims.py`` hold them at the kernels'
head dims and at their tolerances (B13 atol 2e-5 rtol 1e-4; B14p forward
atol 2e-5 rtol 1e-4, gradients atol 5e-5 rtol 1e-3; K1 / B7b forward atol
2e-5, gradients atol 5e-5 rtol 1e-3).  Inputs are made with numpy from a
seed.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unirec_tpu.ops import attention as jatt
from unirec_tpu.ops import flash_vjp as jvjp
from unirec_tpu.ops.flash_causal_vjp import flash_causal_self_attention
from unirec_tpu_torch.ops import attention as pa
from unirec_tpu_torch.ops import flash_causal as fc
from unirec_tpu_torch.ops import flash_vjp as fl
from unirec_tpu_torch.ops import packed_attention as pp

PAD_REL = 1e-6
PADDED = (8, 24, 200, 257, 300)
# the kernels' width for each padded head dim: instance * chunks
INSTANCE = {8: 16, 24: 32, 200: 256, 257: 512, 300: 512}


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


@contextlib.contextmanager
def _true_scale(hd):
    """The plain versions scale by their input's head dim: inside, by the
    true ``hd``'s, as the wrappers pass it to a padded kernel."""
    scale = pa.sm_scale(hd)
    saved = [(mod, mod.sm_scale) for mod in (pa, fl, fc)]
    for mod, _ in saved:
        mod.sm_scale = lambda _hd: scale
    try:
        yield
    finally:
        for mod, fn in saved:
            mod.sm_scale = fn


def _padded(name, hd, inputs, outputs, plain):
    """``plain`` on the padded inputs inside ``padded_launch``; the outputs'
    true columns come back into ``outputs``."""
    def launch(ins, outs, kernel_hd):
        assert kernel_hd == INSTANCE[hd]
        assert all(t.shape[-1] % kernel_hd == 0 for t in ins)
        with _true_scale(hd):
            for out, got in zip(outs, plain(*ins)):
                out.copy_(got)

    pa.padded_launch(name, hd, inputs, [(t, h) for t, h in outputs], launch)
    return [t for t, _ in outputs]


def _mask(rng, b, lkv, masked_row=None):
    mask = (rng.rand(b, lkv) > 0.25).astype(np.float32)
    mask[:, 0] = 1.0
    if masked_row is not None:
        mask[masked_row] = 0.0
    return mask


def _per_head(rng, b, h, lq, lkv, hd):
    return [torch.from_numpy(rng.randn(b, h, n, hd).astype(np.float32))
            for n in (lq, lkv, lkv, lq)]


@pytest.mark.parametrize("hd,want", [(1, 16), (8, 16), (16, 16), (24, 32),
                                     (130, 256), (200, 256), (256, 256)])
def test_kernel_head_dim_is_the_next_instance(hd, want):
    assert pa.kernel_head_dim("K1", hd) == (want, 1)
    pa.check_head_dim("K1", hd)


@pytest.mark.parametrize("hd", [0])
def test_kernel_head_dim_refuses_naming_the_set(hd):
    with pytest.raises(ValueError, match=r"head_dim in \(16, 32.*256\)"):
        pa.kernel_head_dim("K1", hd)


@pytest.mark.parametrize("hd,chunks", [(257, 2), (300, 2), (320, 2),
                                       (512, 2), (513, 3), (1024, 4)])
def test_kernel_head_dim_plans_chunks_above_256(hd, chunks):
    """Above 256: C = ceil(hd / 256) chunks of the 256 instance, the head
    dim zero-padded to C * 256 (``csrc/flash_chunked.cuh``)."""
    assert pa.kernel_head_dim("K1", hd) == (256, chunks)
    pa.check_head_dim("K1", hd)
    t = torch.randn(2, 3, 2 * hd)
    seen = []
    pa.padded_launch("K1", hd, [(t, 2)], [],
                     lambda ins, outs, kernel_hd: seen.append((ins, kernel_hd)))
    (ins,), kernel_hd = seen[0]
    assert kernel_hd == 256 * chunks and ins.shape == (2, 3, 2 * 256 * chunks)
    split = ins.reshape(2, 3, 2, 256 * chunks)
    assert torch.equal(split[..., :hd], t.reshape(2, 3, 2, hd))
    assert not split[..., hd:].any()


def test_padded_launch_passes_instances_as_they_are():
    t = torch.randn(2, 5, 3 * 32)
    seen = []
    pa.padded_launch("K1", 32, [(t, 3)], [(t, 3)],
                     lambda ins, outs, hd: seen.append((ins[0], outs[0], hd)))
    assert seen[0][0] is t and seen[0][1] is t and seen[0][2] == 32


@pytest.mark.parametrize("hd", PADDED)
def test_b13_padded_matches_plain(hd):
    rng = np.random.RandomState(hd)
    q, k, v, _ = _per_head(rng, 2, 3, 8, 150, hd)
    bias = torch.from_numpy(np.array(jatt.make_additive_mask(
        jnp.asarray(_mask(rng, 2, 150, masked_row=1)))))
    want = pa.flash_cross_attention_plain(q, k, v, bias)
    out = torch.empty_like(want)
    _padded("B13", hd, [(q, None), (k, None), (v, None)], [(out, None)],
            lambda *t: (pa.flash_cross_attention_plain(*t, bias),))
    assert _rel(out, want) <= PAD_REL


@pytest.mark.parametrize("hd", PADDED)
def test_b14_padded_merged_heads_match_plain(hd):
    rng = np.random.RandomState(hd + 1)
    b, h, lq, lkv = 2, 3, 8, 150
    q, k3, v3, do = (torch.from_numpy(rng.randn(b, n, h * hd)
                                      .astype(np.float32))
                     for n in (lq, lkv, lkv, lq))
    bias32 = torch.from_numpy((1.0 - _mask(rng, b, lkv, 1)) * -1e9)
    want = fl.flash_cross_fwd_plain(q, k3, v3, bias32, h)
    outs = [torch.empty_like(want[0])]
    stats = []

    def fwd(qp, kp, vp):
        o, m, l = fl.flash_cross_fwd_plain(qp, kp, vp, bias32, h)
        stats.extend((m, l))
        return (o,)

    _padded("B14", hd, [(q, h), (k3, h), (v3, h)], [(outs[0], h)], fwd)
    assert _rel(outs[0], want[0]) <= PAD_REL
    for got, ref in zip(stats, want[1:]):
        assert _rel(got, ref) <= PAD_REL
    m, l = want[1:]
    dsum = fl.attention_dsum(do, want[0], h).contiguous()
    want = fl.flash_cross_bwd_plain(q, k3, v3, bias32, do, m, l, dsum, h)
    grads = [torch.empty_like(t) for t in want]
    _padded("B14", hd, [(q, h), (k3, h), (v3, h), (do, h)],
            [(g, h) for g in grads],
            lambda *t: fl.flash_cross_bwd_plain(*t[:3], bias32, t[3], m, l,
                                                dsum, h))
    for got, ref in zip(grads, want):
        assert _rel(got, ref) <= PAD_REL


@pytest.mark.parametrize("hd", PADDED)
def test_b14p_padded_matches_plain(hd):
    rng = np.random.RandomState(hd + 2)
    q, k, v, do = _per_head(rng, 2, 3, 16, 100, hd)
    bias32 = torch.from_numpy((1.0 - _mask(rng, 2, 100, 0)) * -1e9)
    o, m, l = fl.flash_cross_vjp_fwd_plain(q, k, v, bias32)
    out = torch.empty_like(o)
    _padded("B14p", hd, [(q, None), (k, None), (v, None)], [(out, None)],
            lambda *t: fl.flash_cross_vjp_fwd_plain(*t, bias32)[:1])
    assert _rel(out, o) <= PAD_REL
    dsum = (do * o).sum(-1).transpose(1, 2).contiguous()
    want = fl.flash_cross_vjp_bwd_plain(q, k, v, bias32, do, m, l, dsum)
    grads = [torch.empty_like(t) for t in want]
    _padded("B14p", hd, [(q, None), (k, None), (v, None), (do, None)],
            [(g, None) for g in grads],
            lambda *t: fl.flash_cross_vjp_bwd_plain(*t[:3], bias32, t[3], m,
                                                    l, dsum))
    for got, ref in zip(grads, want):
        assert _rel(got, ref) <= PAD_REL


@pytest.mark.parametrize("hd", PADDED)
def test_k1_b7b_padded_match_plain(hd):
    rng = np.random.RandomState(hd + 3)
    b, l, hq, hkv = 2, 40, 4, 2
    q, do = (torch.from_numpy(rng.randn(b, l, hq * hd).astype(np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(b, l, hkv * hd).astype(np.float32))
            for _ in range(2))
    mask = torch.ones(b, l)
    mask[1, 25:] = 0.0
    want = fc.flash_causal_attention_fwd_plain(q, k, v, mask, hq, hkv)
    out = torch.empty_like(want[0])
    _padded("K1", hd, [(q, hq), (k, hkv), (v, hkv)], [(out, hq)],
            lambda *t: fc.flash_causal_attention_fwd_plain(*t, mask, hq,
                                                           hkv)[:1])
    assert _rel(out, want[0]) <= PAD_REL
    o, m, den = want
    dsum = fc.attention_dsum(do, o, hq).contiguous()
    want = fc.flash_causal_attention_bwd_plain(q, k, v, mask, do, m, den,
                                               dsum, hq, hkv)
    grads = [torch.empty_like(t) for t in want]
    _padded("B7b", hd, [(q, hq), (k, hkv), (v, hkv), (do, hq)],
            [(grads[0], hq), (grads[1], hkv), (grads[2], hkv)],
            lambda *t: fc.flash_causal_attention_bwd_plain(
                *t[:3], mask, t[3], m, den, dsum, hq, hkv))
    for got, ref in zip(grads, want):
        assert _rel(got, ref) <= PAD_REL


@pytest.mark.parametrize("hd", PADDED)
def test_b15_padded_matches_plain(hd):
    """B15 at the head dims the other kernels pad: it runs them as they are
    (the attention core zero-pads inside its tiles), so the plain version
    on the true head dim is held to the JAX kernel in interpret mode
    (atol 2e-5, ``tests/test_torch_packed_attention.py``'s)."""
    from unirec_tpu.ops.packed_attention import packed_item_attention as jp

    rng = np.random.RandomState(hd + 4)
    q, k, v, _ = _per_head(rng, 5, 2, 4, 14, hd)
    mask = _mask(rng, 5, 14, 2)
    bias = np.array(jatt.make_additive_mask(jnp.asarray(mask)))
    got = pp.packed_item_attention(q, k, v, torch.from_numpy(bias))
    want = jp(*(jnp.asarray(t.numpy()) for t in (q, k, v)), jnp.asarray(bias),
              interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


# -- the plain versions at hd 8 and 24 against the JAX kernels ----------------


@pytest.mark.parametrize("hd", [8, 24, 320, 512])
def test_b13_plain_matches_jax_kernel_at_padded_head_dims(hd):
    rng = np.random.RandomState(10 + hd)
    b, h, lq, lkv = 2, 2, 8, 200
    q, k, v = (rng.randn(b, h, n, hd).astype(np.float32)
               for n in (lq, lkv, lkv))
    bias = np.array(jatt.make_additive_mask(jnp.asarray(
        _mask(rng, b, lkv, masked_row=1))))
    want = jatt.flash_cross_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                      jnp.asarray(bias), block_kv=128,
                                      interpret=True)
    got = pa.flash_cross_attention(*(torch.from_numpy(a)
                                     for a in (q, k, v, bias)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("hd", [8, 24, 320, 512])
def test_b14p_plain_matches_jax_kernels_at_padded_head_dims(hd):
    rng = np.random.RandomState(20 + hd)
    b, h, lq, lkv = 2, 3, 16, 384
    q, k, v = (rng.randn(b, h, n, hd).astype(np.float32)
               for n in (lq, lkv, lkv))
    bias = np.array(jatt.make_additive_mask(jnp.asarray(
        _mask(rng, b, lkv))))
    ct = rng.randn(b, h, lq, hd).astype(np.float32)

    def jloss(a, b2, c):
        out = jvjp.flash_cross_attention_vjp(a, b2, c, jnp.asarray(bias), 128,
                                             True)
        return jnp.sum(out * ct), out

    (_, want), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v)))
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = fl.flash_cross_attention_vjp(*leaves, torch.from_numpy(bias))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=2e-5, rtol=1e-4)
    grads = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), leaves)
    for got, ref, name in zip(grads, jgrads, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-5,
                                   rtol=1e-3, err_msg=f"d{name}")


@pytest.mark.parametrize("hd", [8, 24, 320, 512])
def test_k1_b7b_plain_match_jax_kernels_at_padded_head_dims(hd):
    rng = np.random.RandomState(30 + hd)
    b, l, hq, hkv = 2, 72, 4, 2
    q = rng.randn(b, l, hq * hd).astype(np.float32)
    k = rng.randn(b, l, hkv * hd).astype(np.float32)
    v = rng.randn(b, l, hkv * hd).astype(np.float32)
    mask = np.ones((b, l), np.float32)
    mask[0, 8:40] = 0.0
    mask[-1, l // 2:] = 0.0
    ct = rng.randn(b, l, hq * hd).astype(np.float32)
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = fc.flash_causal_attention_train(*leaves, torch.tensor(mask), hq,
                                          hkv)
    grads = torch.autograd.grad((out * torch.tensor(ct)).sum(), leaves)

    def fn(q_, k_, v_):
        return flash_causal_self_attention(q_, k_, v_, jnp.asarray(mask), hq,
                                           hkv, block=8, interpret=True)

    want, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=2e-5, rtol=0)
    for got, ref, name in zip(grads, vjp(jnp.asarray(ct)), "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-5,
                                   rtol=1e-3, err_msg=f"d{name}")
