"""Port parity: the fused Item Q-Former engine and its blocks (B1-B3),
unirec_tpu_torch (plain versions on the CPU) vs unirec_tpu (Pallas kernels in
interpret mode, and the Flax model).

Config: hidden 64, 3 layers (0 and 2 cross-attend), 4 heads, intermediate
128, K=8 queries, F=6 fields of width 64 or 16 (field width != hidden).
Weights come from Flax ``init`` through ``item_qformer_state_dict_from_flax``;
inputs are numpy draws from fixed seeds.

Tolerances: fp32 atol 2e-5 / rtol 1e-4, the JAX engine tests' own.  bf16
blocks: atol 3.2e-2, one bf16 ulp at the top of a LayerNorm output's range
(|y| < 8): both sides round at the same points, but sum in different orders,
which can flip one rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unirec_tpu.configs import ItemQFormerConfig
from unirec_tpu.inference import fused_qformer as jax_engine
from unirec_tpu.models.item_qformer import ItemQFormer as JaxItemQFormer
from unirec_tpu.ops import fused_qformer_layer as jax_fq
from unirec_tpu_torch.inference.fused_qformer import (
    fused_qformer_forward,
    prepare_fused_params,
    supports_fused,
)
from unirec_tpu_torch.models.item_qformer import ItemQFormer
from unirec_tpu_torch.ops import fused_qformer_layer as fq
from unirec_tpu_torch.utils.weights import item_qformer_state_dict_from_flax

F, K, HEADS = 6, 8, 4
ATOL, RTOL = 2e-5, 1e-4
BF16_ATOL = 3.2e-2
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _cfg(dm=64, **kw):
    return ItemQFormerConfig(
        hidden_size=64, num_hidden_layers=3, num_attention_heads=HEADS,
        intermediate_size=128, num_query_tokens=K, field_embedding_dim=dm,
        num_fields=F, dropout=0.0, **kw)


def _inputs(n, dm, seed=0):
    rng = np.random.RandomState(seed)
    fields = rng.randn(n, F, dm).astype(np.float32)
    mask = (rng.rand(n, F) > 0.25).astype(np.float32)
    mask[:, 0] = 1.0
    return fields, mask


@pytest.fixture(scope="module", params=[64, 16], ids=["dm64", "dm16"])
def setup(request):
    dm = request.param
    cfg = _cfg(dm)
    jm = JaxItemQFormer(cfg)
    fields, mask = _inputs(9, dm)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(fields[:2]),
                     jnp.asarray(mask[:2]))
    sd = item_qformer_state_dict_from_flax(params)
    pm = ItemQFormer(cfg).eval()
    pm.load_state_dict(sd)
    return cfg, jm, params, sd, pm, fields, mask


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _port_forward(cfg, sd, fields, mask):
    fused = prepare_fused_params(sd, cfg, dtype=torch.float32)
    with torch.no_grad():
        return fused_qformer_forward(fused, cfg, _t(fields), _t(mask))


def _jax_forward(cfg, params, fields, mask):
    fused = jax_engine.prepare_fused_params(params, cfg, dtype=jnp.float32)
    return jax_engine.fused_qformer_forward(
        fused, cfg, jnp.asarray(fields), jnp.asarray(mask), interpret=True)


@pytest.mark.parametrize("block", ["self", "cross", "ffn"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_block_matches_jax_kernel(setup, block, dtype):
    cfg, _, params, sd, _, fields, mask = setup
    jdt, tdt = DTYPES[dtype]
    jl = jax_engine.prepare_fused_params(params, cfg, dtype=jdt).layers[0]
    pl = prepare_fused_params(sd, cfg, dtype=tdt).layers[0]
    rng = np.random.RandomState(1)
    x = rng.randn(5, K, 64).astype(np.float32)
    mask = mask[:5].copy()
    mask[2] = 0.0  # an item with no field
    bias = (1.0 - mask) * fq.NEG_INF
    mem = fields[:5]
    jx, px = jnp.asarray(x, jdt), _t(x).to(tdt)
    jm, pmem = jnp.asarray(mem, jdt), _t(mem).to(tdt)
    if block == "self":
        want = jax_fq.fused_self_attention_block(
            jx, jl.wqkv, jl.bqkv, jl.self_wo, jl.self_bo, jl.self_ln_g,
            jl.self_ln_b, num_heads=HEADS, n_q=K, interpret=True)
        got = fq.fused_self_attention_block(
            px, pl.wqkv, pl.bqkv, pl.self_wo, pl.self_bo, pl.self_ln_g,
            pl.self_ln_b, num_heads=HEADS, n_q=K)
    elif block == "cross":
        want = jax_fq.fused_cross_attention_block(
            jx, jm, jnp.asarray(bias), jl.wq, jl.bq, jl.wkv, jl.bkv,
            jl.cross_wo, jl.cross_bo, jl.cross_ln_g, jl.cross_ln_b,
            num_heads=HEADS, n_q=K, n_kv=F, interpret=True)
        got = fq.fused_cross_attention_block(
            px, pmem, _t(bias), pl.wq, pl.bq, pl.wkv, pl.bkv, pl.cross_wo,
            pl.cross_bo, pl.cross_ln_g, pl.cross_ln_b, num_heads=HEADS, n_q=K,
            n_kv=F)
    else:
        want = jax_fq.fused_ffn_block(
            jx, jl.w1, jl.b1, jl.w2, jl.b2, jl.ffn_ln_g, jl.ffn_ln_b,
            interpret=True)
        got = fq.fused_ffn_block(px, pl.w1, pl.b1, pl.w2, pl.b2, pl.ffn_ln_g,
                                 pl.ffn_ln_b)
    assert got.dtype == tdt and got.shape == want.shape
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "fp32":
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_ATOL,
                                   rtol=0)


def test_forward_matches_jax_engine_and_model(setup):
    cfg, _, params, sd, pm, fields, mask = setup
    got = _port_forward(cfg, sd, fields, mask)
    want = _jax_forward(cfg, params, fields, mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    with torch.no_grad():
        model = pm.query_outputs(_t(fields), _t(mask))
    np.testing.assert_allclose(got.numpy(), model.numpy(), atol=ATOL,
                               rtol=RTOL)


def test_all_missing_item_matches_model_and_ignores_batch(setup):
    cfg, _, _, sd, pm, fields, mask = setup
    mask = mask.copy()
    mask[3] = 0.0  # item 3: no valid field at all
    got = _port_forward(cfg, sd, fields, mask)
    with torch.no_grad():
        model = pm.query_outputs(_t(fields), _t(mask))
    np.testing.assert_allclose(got.numpy(), model.numpy(), atol=ATOL,
                               rtol=RTOL)
    poisoned = fields.copy()
    poisoned[4] += 100.0
    other = _port_forward(cfg, sd, poisoned, mask)
    np.testing.assert_allclose(other[3].numpy(), got[3].numpy(), atol=1e-5)
    alone = _port_forward(cfg, sd, fields[3:4], mask[3:4])
    np.testing.assert_allclose(alone[0].numpy(), got[3].numpy(), atol=1e-5)


def test_masked_field_values_are_ignored(setup):
    cfg, _, _, sd, _, fields, mask = setup
    mask = mask.copy()
    mask[:, -1] = 0.0
    poisoned = fields.copy()
    poisoned[:, -1] = 1e3
    a = _port_forward(cfg, sd, fields, mask)
    b = _port_forward(cfg, sd, poisoned, mask)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


@pytest.mark.parametrize("n", [1, 5, 9])
def test_batch_sizes_match_model(setup, n):
    cfg, _, _, sd, pm, fields, mask = setup
    got = _port_forward(cfg, sd, fields[:n], mask[:n])
    with torch.no_grad():
        model = pm.query_outputs(_t(fields[:n]), _t(mask[:n]))
    assert got.shape == (n, K, 64)
    np.testing.assert_allclose(got.numpy(), model.numpy(), atol=ATOL,
                               rtol=RTOL)


def test_field_type_embeddings_match_jax():
    cfg = _cfg(64, use_field_type_embeddings=True)
    jm = JaxItemQFormer(cfg)
    fields, mask = _inputs(4, 64, seed=1)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(fields[:2]),
                     jnp.asarray(mask[:2]))
    sd = item_qformer_state_dict_from_flax(params)
    assert "field_id_embeddings" in sd
    want = jm.apply(params, jnp.asarray(fields), jnp.asarray(mask))[
        "query_outputs"]
    got = _port_forward(cfg, sd, fields, mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    want_engine = _jax_forward(cfg, params, fields, mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_engine),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("config", [
    _cfg(), ItemQFormerConfig(), ItemQFormerConfig(num_query_tokens=3),
    ItemQFormerConfig(num_query_tokens=256), ItemQFormerConfig(
        num_query_tokens=512), ItemQFormerConfig(intermediate_size=1000),
    ItemQFormerConfig(intermediate_size=1536), ItemQFormerConfig(
        hidden_size=1000, num_attention_heads=16),
], ids=["small", "production", "k3", "k256", "k512", "i1000", "i1536",
        "h1000"])
def test_supports_fused_answers_as_jax(config):
    assert supports_fused(config) == jax_engine.supports_fused(config)


@pytest.mark.parametrize("inter", [4096, 2048, 1536, 1000, 128, 100])
def test_ffn_chunk_size_answers_as_jax(inter):
    assert fq.ffn_chunk_size(inter) == jax_fq.ffn_chunk_size(inter)


def test_prepare_fused_params_packing(setup):
    cfg, _, params, sd, _, _, _ = setup
    jp = jax_engine.prepare_fused_params(params, cfg, dtype=jnp.bfloat16)
    pp = prepare_fused_params(sd, cfg, dtype=torch.bfloat16)
    assert len(pp.layers) == cfg.num_hidden_layers
    assert pp.field_id_embeddings is None
    for i, (jl, pl) in enumerate(zip(jp.layers, pp.layers)):
        assert pl.has_cross == jl.has_cross == (i % 2 == 0)
        names = ["wqkv", "self_wo", "w1", "w2"]
        names += ["wq", "wkv", "cross_wo"] if jl.has_cross else []
        for name in names:  # [in, out] in JAX, [out, in] here
            w = getattr(pl, name)
            assert w.dtype == torch.bfloat16 and w.is_contiguous(), name
            np.testing.assert_array_equal(
                w.float().numpy(),
                np.asarray(getattr(jl, name).astype(jnp.float32)).T,
                err_msg=name)
        vecs = ["bqkv", "self_bo", "self_ln_g", "self_ln_b", "b1", "b2",
                "ffn_ln_g", "ffn_ln_b"]
        vecs += (["bq", "bkv", "cross_bo", "cross_ln_g", "cross_ln_b"]
                 if jl.has_cross else [])
        for name in vecs:  # float32 holding the engine dtype's values
            v = getattr(pl, name)
            assert v.dtype == torch.float32, name
            np.testing.assert_array_equal(
                v.numpy(), np.asarray(getattr(jl, name).astype(jnp.float32)),
                err_msg=name)
    assert pp.layers[0].wqkv.shape == (3 * 64, 64)
    assert pp.layers[0].wkv.shape == (2 * 64, cfg.field_embedding_dim)
    np.testing.assert_array_equal(
        pp.query_embeddings.float().numpy(),
        np.asarray(jp.query_embeddings.astype(jnp.float32)))
    assert not pp.layers[0].is_int8 and pp.layers[0].sqkv is None
    q8 = prepare_fused_params(sd, cfg, precision="int8")  # B4-B6's weights
    assert q8.layers[0].is_int8 and q8.layers[0].wqkv.dtype == torch.int8
    assert q8.layers[0].sqkv.shape == (3 * 64,)
    with pytest.raises(ValueError, match="precision"):
        prepare_fused_params(sd, cfg, precision="fp8")


def _bf16_array(rng, *shape, std):
    """(numpy float32 of bf16-rounded values, the same as a JAX bf16 array)"""
    a = torch.from_numpy((rng.randn(*shape) * std).astype(np.float32))
    a = a.bfloat16().float().numpy()
    return a, jnp.asarray(a, jnp.bfloat16)


@pytest.mark.parametrize("d", [1020, 1032])
@pytest.mark.parametrize("block", ["self", "cross", "ffn"])
def test_blocks_at_widths_off_16_byte_rows(block, d):
    """B1-B3 at hidden 1020 (no multiple of 8 bf16 values) and 1032, in 4
    heads: widths supports_fused admits and the kernels now take (C-10;
    the kernels are held to these plain versions on the card,
    test_torch_kernels_gpu and chip_smoke.py).  On CPU tensors the wrapper
    runs its plain version, held to the JAX kernel in interpret mode on the
    same bf16 values (2 items, K 8, F 6, intermediate 256)."""
    assert supports_fused(ItemQFormerConfig(hidden_size=d,
                                            num_attention_heads=4))
    rng = np.random.RandomState(d)
    items, n_q, n_kv, inter, heads = 2, 8, 6, 256, 4
    x, jx = _bf16_array(rng, items, n_q, d, std=1.0)
    mem, jmem = _bf16_array(rng, items, n_kv, d, std=1.0)
    mask = np.ones((items, n_kv), np.float32)
    mask[1, 2:] = 0.0
    bias = (1.0 - mask) * fq.NEG_INF
    shapes = {"self": dict(wqkv=(d, 3 * d), bqkv=3 * d, wo=(d, d), bo=d),
              "cross": dict(wq=(d, d), bq=d, wkv=(d, 2 * d), bkv=2 * d,
                            wo=(d, d), bo=d),
              "ffn": dict(w1=(d, inter), b1=inter, w2=(inter, d), b2=d)}
    w, jw = {}, {}
    for name, shape in shapes[block].items():
        std = 0.1 if isinstance(shape, int) else shape[0] ** -0.5
        w[name], jw[name] = _bf16_array(rng, *np.atleast_1d(shape), std=std)
    g, jg = _bf16_array(rng, d, std=0.1)
    g, jg = g + 1.0, jg + 1.0
    b, jb = _bf16_array(rng, d, std=0.1)
    port = {n: _t(a.T).contiguous() if a.ndim == 2 else _t(a)
            for n, a in w.items()}
    args = dict(num_heads=heads, n_q=n_q)
    if block == "self":
        want = jax_fq.fused_self_attention_block(
            jnp.asarray(jx), jw["wqkv"], jw["bqkv"], jw["wo"], jw["bo"], jg,
            jb, **args, interpret=True)
        got = fq.fused_self_attention_block(
            _t(x).bfloat16(), port["wqkv"].bfloat16(), port["bqkv"],
            port["wo"].bfloat16(), port["bo"], _t(g), _t(b), **args)
    elif block == "cross":
        want = jax_fq.fused_cross_attention_block(
            jx, jmem, jnp.asarray(bias), jw["wq"], jw["bq"], jw["wkv"],
            jw["bkv"], jw["wo"], jw["bo"], jg, jb, **args, n_kv=n_kv,
            interpret=True)
        got = fq.fused_cross_attention_block(
            _t(x).bfloat16(), _t(mem).bfloat16(), _t(bias),
            port["wq"].bfloat16(), port["bq"], port["wkv"].bfloat16(),
            port["bkv"], port["wo"].bfloat16(), port["bo"], _t(g), _t(b),
            **args, n_kv=n_kv)
    else:
        want = jax_fq.fused_ffn_block(jx, jw["w1"], jw["b1"], jw["w2"],
                                      jw["b2"], jg, jb, interpret=True)
        got = fq.fused_ffn_block(_t(x).bfloat16(), port["w1"].bfloat16(),
                                 port["b1"], port["w2"].bfloat16(),
                                 port["b2"], _t(g), _t(b))
    assert got.shape == (items, n_q, d) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=BF16_ATOL, rtol=0)


@pytest.mark.parametrize("head_dim", [128, 256])
def test_kernel_takes_every_k_that_supports_fused_admits(head_dim):
    """B1 at every K dividing 256 (the K supports_fused admits) in 2 heads of
    128 and of 256 (above the old kernel's limit, C-6), 2 items: on CPU
    tensors the wrapper's plain version agrees with the JAX kernel in
    interpret mode, in float32."""
    d = 2 * head_dim
    rng = np.random.RandomState(6)
    s = d ** -0.5
    w = {n: rng.randn(*shape).astype(np.float32) * s for n, shape in (
        ("wqkv", (d, 3 * d)), ("wo", (d, d)))}
    v = {n: rng.randn(n_).astype(np.float32) * 0.1 for n, n_ in (
        ("bqkv", 3 * d), ("bo", d), ("beta", d))}
    g = 1.0 + 0.1 * rng.randn(d).astype(np.float32)
    for k in (1, 2, 4, 8, 16, 32, 64, 128, 256):
        assert supports_fused(ItemQFormerConfig(
            hidden_size=d, num_attention_heads=2, num_query_tokens=k))
        x = rng.randn(2, k, d).astype(np.float32)
        want = jax_fq.fused_self_attention_block(
            jnp.asarray(x), jnp.asarray(w["wqkv"]), jnp.asarray(v["bqkv"]),
            jnp.asarray(w["wo"]), jnp.asarray(v["bo"]), jnp.asarray(g),
            jnp.asarray(v["beta"]), num_heads=2, n_q=k, interpret=True)
        got = fq.fused_self_attention_block(
            _t(x), _t(w["wqkv"].T).contiguous(), _t(v["bqkv"]),
            _t(w["wo"].T).contiguous(), _t(v["bo"]), _t(g), _t(v["beta"]),
            num_heads=2, n_q=k)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=RTOL, err_msg=f"K={k}")


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_cross_block_takes_300_fields(dtype):
    """B2 at 300 fields per item (2 items, one without a field), newly taken
    by the kernel (C-9): the plain version against the JAX kernel in
    interpret mode, which has no limit on F."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(5)
    b, f, d = 2, 300, 64
    x = rng.randn(b, K, d).astype(np.float32)
    mem = rng.randn(b, f, d).astype(np.float32)
    mask = (rng.rand(b, f) > 0.2).astype(np.float32)
    mask[1] = 0.0
    bias = (1.0 - mask) * fq.NEG_INF
    w = {n: rng.randn(*s).astype(np.float32) * 0.1 for n, s in (
        ("wq", (d, d)), ("wkv", (d, 2 * d)), ("wo", (d, d)))}
    v = {n: rng.randn(s).astype(np.float32) * 0.1 for n, s in (
        ("bq", d), ("bkv", 2 * d), ("bo", d))}
    g, beta = 1.0 + 0.1 * rng.randn(d).astype(np.float32), 0.1 * rng.randn(d)
    want = jax_fq.fused_cross_attention_block(
        jnp.asarray(x, jdt), jnp.asarray(mem, jdt), jnp.asarray(bias),
        jnp.asarray(w["wq"], jdt), jnp.asarray(v["bq"], jdt),
        jnp.asarray(w["wkv"], jdt), jnp.asarray(v["bkv"], jdt),
        jnp.asarray(w["wo"], jdt), jnp.asarray(v["bo"], jdt),
        jnp.asarray(g, jdt), jnp.asarray(beta, jdt), num_heads=HEADS, n_q=K,
        n_kv=f, interpret=True)
    wt = lambda n: _t(w[n].T).to(tdt).contiguous()  # noqa: E731
    vt = lambda a: _t(np.asarray(jnp.asarray(a, jdt).astype(jnp.float32)))  # noqa: E731
    got = fq.fused_cross_attention_block(
        _t(x).to(tdt), _t(mem).to(tdt), _t(bias), wt("wq"), vt(v["bq"]),
        wt("wkv"), vt(v["bkv"]), wt("wo"), vt(v["bo"]), vt(g), vt(beta),
        num_heads=HEADS, n_q=K, n_kv=f)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "fp32":
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_ATOL,
                                   rtol=0)


def test_other_devices_are_refused():
    x = torch.empty(2, K, 64, dtype=torch.bfloat16, device="meta")
    w1 = torch.empty(128, 64, dtype=torch.bfloat16, device="meta")
    w2 = torch.empty(64, 128, dtype=torch.bfloat16, device="meta")
    v = torch.empty(64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fq.fused_ffn_block(x, w1, torch.empty(128, device="meta"), w2, v, v, v)
