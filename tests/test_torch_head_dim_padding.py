"""Head dims that are not a kernel instance (C-4, C-5): the zero-padding of
``ops/attention.padded_launch`` and the plain versions at those head dims.

The attention kernels are built for every multiple of 16 up to 128 and for
256 (``KERNEL_HEAD_DIMS``).  Any other head dim up to 256 runs zero-padded to
the next instance, and above 256 the chunked form (``csrc/flash_chunked.cuh``,
C = ceil(hd / 256) chunks of 256) takes a head dim whose rows are whole
16-byte pieces as it is (zero-filling the last chunk's missing columns as it
loads them) and any other zero-padded to C * 256, with the softmax scale of
the true head dim: zero lanes add exact zeros to every dot product, so the
scores, (m, l), the output and the gradients' true columns do not move.  Without a card that is checked on the plain versions: each
runs on the padded tensors inside ``padded_launch`` (with the true head
dim's scale, as the wrappers pass it to the kernels), and the true columns
it returns are held to the unpadded plain version within 1e-6 relative, for
K1 / B7b, B13, B14 (merged heads) and B14p, at hd 8, 24, 200, 257 and 300
(257 at 2 chunks, padded 512 wide; 300, whole 16-byte float32 pieces, as
it is).  The packed item attention B15 pads
nothing: its kernels take every head dim as it is; at those head dims its
plain version is held to the JAX kernel.

The port's plain B13, B14p and K1 / B7b at hd 8, 24, 320 and 512, and at
the cluster form's head dims (K1 / B7b at 768, B14p at 768 and 1024, B13 at
768, 1024 and 1536; over 40 keys at most), are held to the JAX functions in
interpret mode, as ``tests/test_torch_flash_cross.py``,
``tests/test_torch_flash_vjp.py`` and
``tests/test_torch_flash_causal_head_dims.py`` hold them at the kernels'
head dims and at their tolerances (B13 atol 2e-5 rtol 1e-4; B14p forward
atol 2e-5 rtol 1e-4, gradients atol 5e-5 rtol 1e-3; K1 / B7b forward atol
2e-5, gradients atol 5e-5 rtol 1e-3).  Inputs are made with numpy from a
seed.
"""

import collections
import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_dist_ranks import one_torch_thread  # noqa: F401
from unirec_tpu.ops import attention as jatt
from unirec_tpu.ops import flash_vjp as jvjp
from unirec_tpu.ops.flash_causal_vjp import flash_causal_self_attention
from unirec_tpu_torch.ops import attention as pa
from unirec_tpu_torch.ops import flash_causal as fc
from unirec_tpu_torch.ops import flash_vjp as fl
from unirec_tpu_torch.ops import packed_attention as pp


PAD_REL = 1e-6
PADDED = (8, 24, 200, 257, 300)
# the kernels' width for each head dim in float32: instance * chunks, but
# 300 (rows of whole 16-byte pieces), which the chunked form takes as it is
INSTANCE = {8: 16, 24: 32, 200: 256, 257: 512, 300: 300}


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
    """Above 256: C = ceil(hd / 256) chunks of the 256 instance
    (``csrc/flash_chunked.cuh``); a float32 head dim whose rows are not
    whole 16-byte pieces goes zero-padded to C * 256, any other as it is."""
    assert pa.kernel_head_dim("K1", hd) == (256, chunks)
    pa.check_head_dim("K1", hd)
    t = torch.randn(2, 3, 2 * hd)
    seen = []
    pa.padded_launch("K1", hd, [(t, 2)], [],
                     lambda ins, outs, kernel_hd: seen.append((ins, kernel_hd)))
    (ins,), kernel_hd = seen[0]
    width = hd if hd % 4 == 0 else 256 * chunks
    assert kernel_hd == width and ins.shape == (2, 3, 2 * width)
    split = ins.reshape(2, 3, 2, width)
    assert torch.equal(split[..., :hd], t.reshape(2, 3, 2, hd))
    assert not split[..., hd:].any()


@pytest.mark.parametrize("hd,dtype", [
    (512, torch.bfloat16), (513, torch.bfloat16), (1024, torch.float32),
    (1280, torch.bfloat16), (1281, torch.bfloat16), (2048, torch.bfloat16)])
def test_padded_launch_bounds_bf16_chunks(hd, dtype):
    """bf16 launches at every chunk count, as float32 does (C-19): 513 and
    1281, refused once (above the tensor-core forms' 2 and 5 chunks), go to
    the launch zero-padded to 256 * C, where the kernels pick their form by
    the chunk count (``chunked_form``)."""
    t = torch.zeros(1, 2, hd, dtype=dtype)
    seen = []
    pa.padded_launch("K1", hd, [(t, None)], [],
                     lambda ins, outs, kernel_hd: seen.append(
                         (ins[0].shape[-1], ins[0].dtype, kernel_hd)))
    width = 256 * -(-hd // 256)
    assert seen == [(width, dtype, width)]


@pytest.mark.parametrize("blocks,key_tiles,sms,want", [
    (32, 50, 132, 8),    # B13 / B14 at 8 users, 2 heads of 512, 1,600 keys
    (256, 50, 132, 1),   # the same at 64 users: two blocks an SM already
    (128, 16, 132, 2),
    (4, 9, 132, 2),      # at least 4 key tiles a split
    (8, 3, 132, 1),      # too few key tiles to split
    (600, 50, 132, 1)])
def test_chunked_fwd_splits(blocks, key_tiles, sms, want):
    """The chunked bf16 forward splits each row's keys until its grid holds
    two blocks an SM, each split at least 4 key tiles long."""
    assert pa.chunked_fwd_splits(blocks, key_tiles, sms) == want


@pytest.mark.parametrize("blocks,key_tiles,sms,want", [
    (32, 50, 132, 4),    # B13 / B14 at 8 users, 2 heads of 512, 1,600 keys
    (64, 50, 132, 2),    # one head of 2048 (8 chunks) at 8 users
    (256, 50, 132, 1),   # 64 users: one block an SM already
    (8, 9, 132, 2)])     # at least 4 key tiles a split
def test_chunked_fwd_splits_one_block_an_sm(blocks, key_tiles, sms, want):
    """The float32 cluster form holds one block an SM: its splits fill one
    block an SM (``per_sm`` 1), each split at least 4 key tiles long."""
    assert pa.chunked_fwd_splits(blocks, key_tiles, sms, per_sm=1) == want


def _fwd_plan(q, *args):
    return pa.chunked_plan(q, pa.CHUNKED_FWD, *args)


def _rows_plan(q, *args):
    return pa.chunked_plan(q, pa.CHUNKED_ROWS, *args)


def test_chunked_fwd_plan_sizes_the_merge_scratch(monkeypatch):
    """(splits, scratch) of a launch: float32 scratch of splits * B * H * Lq
    * (kernel_hd + 2) for a split bf16 launch of the tensor-core form at a
    chunked head dim, (1, None) for float32, for the scalar form (bf16
    above 5 chunks), for a head dim of one chunk, and for a grid that fills
    the card."""
    monkeypatch.setattr(pa, "_sm_count", lambda index: 132)
    q = torch.zeros(1, dtype=torch.bfloat16)
    tc = "tensor_cores"
    splits, part = _fwd_plan(q, 8, 2, 64, 1600, 512, tc)
    assert splits == 8 and part.dtype == torch.float32
    assert part.numel() == 8 * 8 * 2 * 64 * (512 + 2)
    splits, part = _fwd_plan(q, 3, 2, 150, 300, 512, tc)
    assert splits == 2 and part.numel() == 2 * 3 * 2 * 150 * 514
    splits, _ = _fwd_plan(q, 8, 2, 64, 1600, 1024, tc)
    assert splits == 4  # 64 blocks at 4 chunks
    assert _fwd_plan(q, 64, 2, 64, 1600, 512, tc) == (1, None)
    assert _fwd_plan(q, 8, 2, 64, 1600, 256, None) == (1, None)
    assert _fwd_plan(q.float(), 8, 2, 64, 1600, 512, "scalar") == (1, None)
    assert _fwd_plan(q, 8, 1, 64, 1600, 1536, "scalar") == (1, None)


def test_chunked_fwd_plan_splits_the_cluster_form(monkeypatch):
    """The cluster form (one block a chunk, ``csrc/flash_chunked_cluster.cuh``)
    takes the key splits and the merge scratch of the tensor-core form: B13
    at 8 users and one head of 1536 (6 chunks, 48 blocks) splits its 50 key
    tiles 5 ways; at 64 users the grid fills the card unsplit."""
    monkeypatch.setattr(pa, "_sm_count", lambda index: 132)
    q = torch.zeros(1, dtype=torch.bfloat16)
    splits, part = _fwd_plan(q, 8, 1, 64, 1600, 1536, "cluster")
    assert splits == 5 and part.dtype == torch.float32
    assert part.numel() == 5 * 8 * 1 * 64 * (1536 + 2)
    splits, part = _fwd_plan(q, 2, 2, 150, 300, 2048, "cluster")
    assert splits == 2 and part.numel() == 2 * 2 * 2 * 150 * (2048 + 2)
    assert _fwd_plan(q, 64, 1, 64, 1600, 1536, "cluster") == (1, None)


def test_chunked_fwd_plan_splits_the_float32_cluster_form(monkeypatch):
    """float32 in its 3xTF32 cluster form ("cluster_tf32",
    ``csrc/flash_chunked_cluster.cuh``) takes the key splits and the merge
    scratch, filling one block an SM: B13 / B14 at 8 users in 2 heads of 512
    (32 blocks) split their 50 key tiles 4 ways, one head of 2048 (64
    blocks) 2 ways; at 64 users the grid fills the card unsplit, and the
    scalar form still takes (1, None)."""
    monkeypatch.setattr(pa, "_sm_count", lambda index: 132)
    q = torch.zeros(1, dtype=torch.float32)
    tf32 = "cluster_tf32"
    splits, part = _fwd_plan(q, 8, 2, 64, 1600, 512, tf32)
    assert splits == 4 and part.dtype == torch.float32
    assert part.numel() == 4 * 8 * 2 * 64 * (512 + 2)
    splits, part = _fwd_plan(q, 8, 1, 64, 1600, 2048, tf32)
    assert splits == 2 and part.numel() == 2 * 8 * 1 * 64 * (2048 + 2)
    splits, part = _fwd_plan(q, 3, 2, 150, 300, 320, tf32)
    assert splits == 2 and part.numel() == 2 * 3 * 2 * 150 * (512 + 2)
    assert _fwd_plan(q, 64, 2, 64, 1600, 512, tf32) == (1, None)
    assert _fwd_plan(q, 8, 2, 64, 1600, 512, "scalar") == (1, None)
    assert _fwd_plan(q, 8, 1, 64, 1600, 2304, "scalar") == (1, None)


def test_chunked_rows_plan_splits_the_float32_backward(monkeypatch):
    """The float32 cluster form's backward over rows (B14, B14p) takes key
    splits over its 16-key tiles and dq scratch, filling one block an SM:
    at 8 users in 2 heads of 512 (32 blocks) 4 splits of the 100 key tiles
    and 4 * 8 * 2 * 64 * 512 floats; at 64 users, for the scalar form and
    for bf16's forms, (1, None)."""
    monkeypatch.setattr(pa, "_sm_count", lambda index: 132)
    q = torch.zeros(1, dtype=torch.float32)
    tf32 = "cluster_tf32"
    splits, part = _rows_plan(q, 8, 2, 64, 1600, 512, tf32)
    assert splits == 4 and part.dtype == torch.float32
    assert part.numel() == 4 * 8 * 2 * 64 * 512
    splits, part = _rows_plan(q, 3, 2, 70, 300, 320, tf32)
    assert splits == 4 and part.numel() == 4 * 3 * 2 * 70 * 512
    assert _rows_plan(q, 64, 2, 64, 1600, 512, tf32) == (1, None)
    assert _rows_plan(q, 8, 2, 64, 1600, 512, "scalar") == (1, None)
    for form in ("tensor_cores", "cluster"):
        assert _rows_plan(q.bfloat16(), 8, 2, 64, 1600, 512, form) == (1,
                                                                        None)


def test_chunked_causal_plan_splits_the_float32_k1_and_dq(monkeypatch):
    """The float32 cluster form's K1 and B7b's dq split the keys of a causal
    grid of up to two blocks an SM (its last q tiles visit the most key
    tiles): at B 2, L 512, 4 heads of 512 (128 blocks) both split in two,
    K1 with (o, m, l) scratch, dq with dq scratch; a grid of more blocks, the
    scalar form and bf16's forms take (1, None)."""
    monkeypatch.setattr(pa, "_sm_count", lambda index: 132)
    q = torch.zeros(1, dtype=torch.float32)
    tf32 = "cluster_tf32"

    def plan(kind, b, l, h, form, t=q):
        return pa.chunked_plan(t, kind, b, h, l, l, 512, form, causal=True)

    splits, part = plan(pa.CHUNKED_FWD, 2, 512, 4, tf32)
    assert splits == 2 and part.numel() == 2 * 2 * 4 * 512 * (512 + 2)
    splits, part = plan(pa.CHUNKED_ROWS, 2, 512, 4, tf32)
    assert splits == 2 and part.numel() == 2 * 2 * 4 * 512 * 512
    assert plan(pa.CHUNKED_ROWS, 8, 512, 16, tf32) == (1, None)
    assert plan(pa.CHUNKED_FWD, 2, 512, 4, "scalar") == (1, None)
    for form in ("tensor_cores", "cluster"):
        assert plan(pa.CHUNKED_ROWS, 2, 512, 4, form, q.bfloat16()) == (1,
                                                                        None)
        # bf16's K1 takes no split (the cross forward's rule is not causal)
        assert plan(pa.CHUNKED_FWD, 2, 512, 4, form, q.bfloat16()) == (1,
                                                                       None)


@pytest.mark.parametrize("code,name", [(0, None), (1, "scalar"),
                                       (2, "tensor_cores"), (3, "cluster"),
                                       (4, "cluster_tf32")])
def test_chunked_form_names_the_kernels_code(monkeypatch, code, name):
    """``chunked_form`` names the code ``unirec_chunked_form`` returns (3:
    the cluster form) for the kind, head dim and dtype code it asks about,
    and ``count_form`` counts a launch under that name; a negative code (a
    kind or dtype out of range) raises."""
    seen, codes = [], {pa.CHUNKED_ROWS: code, pa.CHUNKED_FWD: code,
                       pa.CHUNKED_KEYS: -1}

    def form(kind, hd, dtype):
        seen.append((kind, hd, dtype))
        return codes[kind]

    lib = types.SimpleNamespace(unirec_chunked_form=form)
    monkeypatch.setattr(pa, "load_kernels",
                        lambda: types.SimpleNamespace(lib=lib))
    pa._chunked_form.cache_clear()
    try:
        t = torch.zeros(1, dtype=torch.bfloat16)
        assert pa.chunked_form(pa.CHUNKED_ROWS, 768, t) == name
        assert seen == [(pa.CHUNKED_ROWS, 768, 1)]
        wrapper = types.SimpleNamespace(forms=collections.Counter())
        pa.count_form(wrapper, pa.CHUNKED_FWD, 1536, t)
        assert dict(wrapper.forms) == ({} if name is None else {name: 1})
        with pytest.raises(ValueError, match="no chunked kind"):
            pa.chunked_form(pa.CHUNKED_KEYS, 768, t.float())
    finally:
        pa._chunked_form.cache_clear()


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


# head dims of the bf16 cluster form (``csrc/flash_chunked_cluster.cuh``)
# run at a few keys: the JAX kernels in interpret mode hold the whole head
WIDE_LKV = 40


@pytest.mark.parametrize("hd", [8, 24, 320, 512, 768, 1024, 1536])
def test_b13_plain_matches_jax_kernel_at_padded_head_dims(hd):
    rng = np.random.RandomState(10 + hd)
    b, h, lq, lkv = 2, 2, 8, 200 if hd <= 512 else WIDE_LKV
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


@pytest.mark.parametrize("hd", [8, 24, 320, 512, 768, 1024])
def test_b14p_plain_matches_jax_kernels_at_padded_head_dims(hd):
    rng = np.random.RandomState(20 + hd)
    b, h, lq, lkv = (2, 3, 16, 384) if hd <= 512 else (2, 1, 16, WIDE_LKV)
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


@pytest.mark.parametrize("hd", [8, 24, 320, 512, 768])
def test_k1_b7b_plain_match_jax_kernels_at_padded_head_dims(hd):
    rng = np.random.RandomState(30 + hd)
    b, l, hq, hkv = 2, 72 if hd <= 512 else WIDE_LKV, 4, 2
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
