"""Port parity: the int8 (W8A8) Item Q-Former engine and its blocks (B4-B6),
unirec_tpu_torch (plain versions on the CPU) vs unirec_tpu (Pallas kernels in
interpret mode, and the Flax model).

Config as ``tests/test_fused_int8.py``: hidden 64, 3 layers (0 and 2
cross-attend), 4 heads, intermediate 128, K=8 queries, F=6 fields of width
64 or 16.  Weights come from Flax ``init`` through
``item_qformer_state_dict_from_flax``; inputs are numpy draws from fixed
seeds.

Tolerances: weight and row quantization bit for bit (codes and scales).
Blocks: atol 6.25e-2, rtol 0 (two bf16 ulps at |y| < 8): both sides round at
the same points and their int products are exact, but fp32 sums of attention
and LayerNorm (and XLA's tanh) can run in another order, which can flip one
bf16 rounding and through it one int8 code.  Engine: per-token cosine >=
0.9999 against the JAX int8 engine and >= 0.995 against the fp32 model (the
bound of ``tests/test_fused_int8.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_dist_ranks import one_torch_thread  # noqa: F401
from unirec_tpu.configs import ItemQFormerConfig
from unirec_tpu.inference import fused_qformer as jax_engine
from unirec_tpu.inference.qformer_inference import (
    QFormerInference as JaxQFormerInference,
)
from unirec_tpu.models.item_qformer import ItemQFormer as JaxItemQFormer
from unirec_tpu.ops import fused_qformer_int8 as jax_q
from unirec_tpu.ops.fused_qformer_layer import (
    ffn_chunk_size as jax_ffn_chunk_size,
)
from unirec_tpu_torch.inference.fused_qformer import (
    fused_qformer_forward,
    prepare_fused_params,
)
from unirec_tpu_torch.inference.qformer_inference import QFormerInference
from unirec_tpu_torch.ops import fused_qformer_int8 as pq
from unirec_tpu_torch.ops.fused_qformer_layer import NEG_INF
from unirec_tpu_torch.utils.weights import item_qformer_state_dict_from_flax


F, K, HEADS, D = 6, 8, 4, 64
BLOCK_ATOL = 6.25e-2
JAX_ENGINE_COS, FP32_COS = 0.9999, 0.995


def _cfg(dm=64, **kw):
    return ItemQFormerConfig(
        hidden_size=D, num_hidden_layers=3, num_attention_heads=HEADS,
        intermediate_size=128, num_query_tokens=K, field_embedding_dim=dm,
        num_fields=F, dropout=0.0, **kw)


@pytest.fixture(scope="module", params=[64, 16], ids=["dm64", "dm16"])
def setup(request):
    dm = request.param
    cfg = _cfg(dm)
    rng = np.random.RandomState(0)
    fields = rng.randn(9, F, dm).astype(np.float32)
    mask = (rng.rand(9, F) > 0.25).astype(np.float32)
    mask[:, 0] = 1.0
    params = JaxItemQFormer(cfg).init(jax.random.PRNGKey(0),
                                      jnp.asarray(fields[:2]),
                                      jnp.asarray(mask[:2]))
    sd = item_qformer_state_dict_from_flax(params)
    return cfg, params, sd, fields, mask


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _token_cos(a, b):
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


def _port_int8(cfg, sd, fields, mask):
    fused = prepare_fused_params(sd, cfg, precision="int8")
    with torch.no_grad():
        out = fused_qformer_forward(fused, cfg, _t(fields), _t(mask))
    return out.float().numpy()


@pytest.mark.parametrize("case", ["ranges", "tiny_columns"])
def test_quantize_weight_matches_jax(case):
    rng = np.random.RandomState(3)
    w = rng.randn(64, 128).astype(np.float32) * np.linspace(0.01, 5.0, 128)
    if case == "tiny_columns":  # absmax below the 1e-8 floor, and zeros
        w[:, :4] *= 1e-10
        w[:, 4] = 0.0
    jq, js = jax_q.quantize_weight(jnp.asarray(w))  # [in, out], [1, out]
    pq_, ps = pq.quantize_weight(torch.from_numpy(w.T.copy()))
    assert pq_.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(pq_.numpy(), np.asarray(jq).T)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js)[0])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_row_quant_matches_jax(dtype):
    rng = np.random.RandomState(4)
    x = rng.randn(40, 96).astype(np.float32) * rng.uniform(
        1e-3, 30.0, (40, 1)).astype(np.float32)
    x[3] = 0.0  # a row below the 1e-6 floor
    x[5, 7] = 2.5 * np.abs(x[5]).max()  # codes at exactly +-127
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    jx = jnp.asarray(x, jdt)
    jcodes, jscale = jax_q._row_quant(jx.astype(jnp.float32))
    codes, scale = pq.row_quant(_t(x).to(tdt))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))


def test_prepare_fused_params_int8_matches_jax(setup):
    cfg, params, sd, _, _ = setup
    jp = jax_engine.prepare_fused_params(params, cfg, precision="int8")
    pp = prepare_fused_params(sd, cfg, precision="int8")
    for jl, pl in zip(jp.layers, pp.layers):
        assert pl.is_int8 and jl.is_int8 and pl.has_cross == jl.has_cross
        names = [("wqkv", "sqkv"), ("self_wo", "self_so"), ("w1", "s1"),
                 ("w2", "s2")]
        if jl.has_cross:
            names += [("wq", "sq"), ("wkv", "skv"), ("cross_wo", "cross_so")]
        for w, s in names:  # [in, out] + [1, out] in JAX
            assert getattr(pl, w).dtype == torch.int8, w
            np.testing.assert_array_equal(getattr(pl, w).numpy(),
                                          np.asarray(getattr(jl, w)).T,
                                          err_msg=w)
            np.testing.assert_array_equal(getattr(pl, s).numpy(),
                                          np.asarray(getattr(jl, s))[0],
                                          err_msg=s)
        for name in ("bqkv", "self_bo", "b1", "b2", "ffn_ln_g"):
            np.testing.assert_array_equal(getattr(pl, name).numpy(),
                                          _np(getattr(jl, name)), err_msg=name)


def _block_inputs(mask, fields, seed=1):
    rng = np.random.RandomState(seed)
    x = rng.randn(5, K, D).astype(np.float32)
    mask = mask[:5].copy()
    mask[2] = 0.0  # an item with no field
    return x, (1.0 - mask) * NEG_INF, fields[:5]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("block", ["self", "cross", "ffn"])
def test_block_q_matches_jax_kernel(setup, block, dtype):
    """B4-B6 at bfloat16 and float32 activations (the JAX kernels quantize
    float32 rows from their float32 values and return float32)."""
    cfg, params, sd, fields, mask = setup
    jl = jax_engine.prepare_fused_params(params, cfg,
                                         precision="int8").layers[0]
    pl = prepare_fused_params(sd, cfg, precision="int8").layers[0]
    x, bias, mem = _block_inputs(mask, fields)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, px = jnp.asarray(x, jdt), _t(x).to(tdt)
    jm, pm = jnp.asarray(mem, jdt), _t(mem).to(tdt)
    if block == "self":
        want = jax_q.fused_self_attention_block_q(
            jx, jl.wqkv, jl.sqkv, jl.bqkv, jl.self_wo, jl.self_so, jl.self_bo,
            jl.self_ln_g, jl.self_ln_b, num_heads=HEADS, n_q=K, interpret=True)
        got = pq.fused_self_attention_block_q(
            px, pl.wqkv, pl.sqkv, pl.bqkv, pl.self_wo, pl.self_so, pl.self_bo,
            pl.self_ln_g, pl.self_ln_b, num_heads=HEADS, n_q=K)
    elif block == "cross":
        want = jax_q.fused_cross_attention_block_q(
            jx, jm, jnp.asarray(bias), jl.wq, jl.sq, jl.bq, jl.wkv, jl.skv,
            jl.bkv, jl.cross_wo, jl.cross_so, jl.cross_bo, jl.cross_ln_g,
            jl.cross_ln_b, num_heads=HEADS, n_q=K, n_kv=F, interpret=True)
        got = pq.fused_cross_attention_block_q(
            px, pm, _t(bias), pl.wq, pl.sq, pl.bq, pl.wkv, pl.skv, pl.bkv,
            pl.cross_wo, pl.cross_so, pl.cross_bo, pl.cross_ln_g,
            pl.cross_ln_b, num_heads=HEADS, n_q=K, n_kv=F)
    else:
        want = jax_q.fused_ffn_block_q(
            jx, jl.w1, jl.s1, jl.b1, jl.w2, jl.s2, jl.b2, jl.ffn_ln_g,
            jl.ffn_ln_b, interpret=True)
        got = pq.fused_ffn_block_q(px, pl.w1, pl.s1, pl.b1, pl.w2, pl.s2,
                                   pl.b2, pl.ffn_ln_g, pl.ffn_ln_b)
    assert got.dtype == tdt and got.shape == want.shape
    assert want.dtype == jdt
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               atol=BLOCK_ATOL, rtol=0)


@pytest.mark.parametrize("d", [1020, 1032])
@pytest.mark.parametrize("block", ["self", "cross", "ffn"])
def test_block_q_at_widths_off_16_byte_rows(block, d):
    """B4-B6 at hidden 1020 and 1032 in 4 heads (no multiple of 16 int8
    codes; the kernels now take them on gemm_wide.cuh's int8 edge kernel,
    C-10, held to these plain versions on the card): on CPU tensors the
    wrapper's plain version against the JAX kernel in interpret mode, the
    same weights quantized on each side (2 items, K 8, F 6, intermediate
    256)."""
    rng = np.random.RandomState(d + 1)
    items, n_q, n_kv, inter, heads = 2, 8, 6, 256, 4
    x = rng.randn(items, n_q, d).astype(np.float32)
    mem = rng.randn(items, n_kv, d).astype(np.float32)
    mask = np.ones((items, n_kv), np.float32)
    mask[1, 2:] = 0.0
    bias = (1.0 - mask) * NEG_INF
    shapes = {"self": dict(wqkv=(d, 3 * d), wo=(d, d)),
              "cross": dict(wq=(d, d), wkv=(d, 2 * d), wo=(d, d)),
              "ffn": dict(w1=(d, inter), w2=(inter, d))}[block]
    jw, pw = {}, {}
    for name, (i, o) in shapes.items():  # [in, out] in JAX, [out, in] here
        w = (rng.randn(i, o) * i ** -0.5).astype(np.float32)
        jw[name] = jax_q.quantize_weight(jnp.asarray(w))
        pw[name] = pq.quantize_weight(_t(w.T))
    sizes = {"self": dict(bqkv=3 * d, bo=d),
             "cross": dict(bq=d, bkv=2 * d, bo=d),
             "ffn": dict(b1=inter, b2=d)}[block]
    vec = {n: (rng.randn(n_) * 0.1).astype(np.float32)
           for n, n_ in dict(sizes, g=d, be=d).items()}
    vec["g"] += 1.0
    jv = {n: jnp.asarray(a) for n, a in vec.items()}
    pv = {n: _t(a) for n, a in vec.items()}
    jx, px = jnp.asarray(x, jnp.bfloat16), _t(x).bfloat16()
    kw = dict(num_heads=heads, n_q=n_q)
    if block == "self":
        want = jax_q.fused_self_attention_block_q(
            jx, *jw["wqkv"], jv["bqkv"], *jw["wo"], jv["bo"], jv["g"],
            jv["be"], **kw, interpret=True)
        got = pq.fused_self_attention_block_q(
            px, *pw["wqkv"], pv["bqkv"], *pw["wo"], pv["bo"], pv["g"],
            pv["be"], **kw)
    elif block == "cross":
        want = jax_q.fused_cross_attention_block_q(
            jx, jnp.asarray(mem, jnp.bfloat16), jnp.asarray(bias), *jw["wq"],
            jv["bq"], *jw["wkv"], jv["bkv"], *jw["wo"], jv["bo"], jv["g"],
            jv["be"], **kw, n_kv=n_kv, interpret=True)
        got = pq.fused_cross_attention_block_q(
            px, _t(mem).bfloat16(), _t(bias), *pw["wq"], pv["bq"],
            *pw["wkv"], pv["bkv"], *pw["wo"], pv["bo"], pv["g"], pv["be"],
            **kw, n_kv=n_kv)
    else:
        want = jax_q.fused_ffn_block_q(
            jx, *jw["w1"], jv["b1"], *jw["w2"], jv["b2"], jv["g"], jv["be"],
            interpret=True)
        got = pq.fused_ffn_block_q(px, *pw["w1"], pv["b1"], *pw["w2"],
                                   pv["b2"], pv["g"], pv["be"])
    assert got.shape == (items, n_q, d) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               atol=BLOCK_ATOL, rtol=0)


@pytest.mark.parametrize("inter,chunk", [(256, 128), (4224, None)],
                         ids=["explicit_chunk", "above_4096"])
def test_ffn_q_groupings_match_jax(inter, chunk):
    """h is requantized per chunk: two chunks of 128 given explicitly, and
    an intermediate above 4096 that takes ffn_chunk_size (11 chunks of
    384)."""
    rng = np.random.RandomState(5)
    x = rng.randn(4, K, D).astype(np.float32)
    w1 = (rng.randn(D, inter) * 0.2).astype(np.float32)
    w2 = (rng.randn(inter, D) * 0.05).astype(np.float32)
    b1 = (rng.randn(inter) * 0.1).astype(np.float32)
    b2 = (rng.randn(D) * 0.1).astype(np.float32)
    g, be = np.ones(D, np.float32), np.zeros(D, np.float32)
    j1, js1 = jax_q.quantize_weight(jnp.asarray(w1))
    j2, js2 = jax_q.quantize_weight(jnp.asarray(w2))
    want = jax_q.fused_ffn_block_q(
        jnp.asarray(x, jnp.bfloat16), j1, js1, jnp.asarray(b1), j2, js2,
        jnp.asarray(b2), jnp.asarray(g), jnp.asarray(be), chunk=chunk,
        interpret=True)
    p1, ps1 = pq.quantize_weight(_t(w1.T))
    p2, ps2 = pq.quantize_weight(_t(w2.T))
    got = pq.fused_ffn_block_q(_t(x).bfloat16(), p1, ps1, _t(b1), p2, ps2,
                               _t(b2), _t(g), _t(be), chunk=chunk)
    assert pq.ffn_q_chunk(inter, chunk) == (chunk or 384)
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               atol=BLOCK_ATOL, rtol=0)
    # the grouping is part of the numbers: one chunk gives other outputs
    whole = pq.fused_ffn_block_q(_t(x).bfloat16(), p1, ps1, _t(b1), p2, ps2,
                                 _t(b2), _t(g), _t(be), chunk=inter)
    assert not torch.equal(whole, got)


@pytest.mark.parametrize("inter", [4096, 128, 4224, 1536, 1000])
def test_ffn_q_chunk_is_the_jax_rule(inter):
    """fused_ffn_block_q: the whole intermediate when <= 4096 and a multiple
    of 128, else ffn_chunk_size; none at all is refused."""
    want = (inter if inter <= 4096 and inter % 128 == 0
            else jax_ffn_chunk_size(inter))
    if not want:
        with pytest.raises(ValueError):
            pq.ffn_q_chunk(inter)
    else:
        assert pq.ffn_q_chunk(inter) == want


def test_int8_forward_matches_jax_engine_and_fp32_model(setup):
    cfg, params, sd, fields, mask = setup
    got = _port_int8(cfg, sd, fields, mask)
    jp = jax_engine.prepare_fused_params(params, cfg, precision="int8")
    want = np.asarray(jax_engine.fused_qformer_forward(
        jp, cfg, jnp.asarray(fields), jnp.asarray(mask), interpret=True),
        np.float32)
    assert got.shape == want.shape == (9, K, D)
    assert _token_cos(got, want).min() >= JAX_ENGINE_COS
    ref = np.asarray(JaxItemQFormer(cfg).apply(
        params, jnp.asarray(fields), jnp.asarray(mask))["query_outputs"])
    assert _token_cos(got, ref).min() >= FP32_COS


def test_int8_masked_field_invariance(setup):
    """Masked fields must not influence int8 outputs (exact)."""
    cfg, _, sd, fields, mask = setup
    mask = mask.copy()
    mask[:, -1] = 0.0
    poisoned = fields.copy()
    poisoned[:, -1] = 1e3
    np.testing.assert_array_equal(_port_int8(cfg, sd, fields, mask),
                                  _port_int8(cfg, sd, poisoned, mask))


def test_int8_all_missing_item_ignores_batch(setup):
    cfg, _, sd, fields, mask = setup
    mask = mask.copy()
    mask[3] = 0.0
    full = _port_int8(cfg, sd, fields, mask)
    alone = _port_int8(cfg, sd, fields[3:4], mask[3:4])
    np.testing.assert_array_equal(alone[0], full[3])
    assert np.isfinite(full).all()


def test_plain_flag_runs_the_int8_plain_blocks(setup, monkeypatch):
    cfg, _, sd, fields, mask = setup
    fused = prepare_fused_params(sd, cfg, precision="int8")
    calls = []
    real = pq.fused_ffn_block_q_plain
    monkeypatch.setattr(pq, "fused_ffn_block_q_plain",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    with torch.no_grad():
        out = fused_qformer_forward(fused, cfg, _t(fields), _t(mask),
                                    plain=True)
    assert len(calls) == cfg.num_hidden_layers
    np.testing.assert_array_equal(out.float().numpy(),
                                  _port_int8(cfg, sd, fields, mask))


def _common(cfg, sd):
    return dict(config=cfg, params=sd, field_names=[f"f{i}" for i in range(F)],
                device="cpu", batch_size=4)


def test_inference_precision_int8(setup):
    cfg, params, sd, fields, mask = setup
    q8 = QFormerInference(**_common(cfg, sd), precision="int8")
    assert q8.use_fused and q8.precision == "int8" and q8.model is None
    assert q8.fused_params.layers[0].is_int8
    got = q8.query_tokens_from_embeddings(fields, mask)
    jax_q8 = JaxQFormerInference(config=cfg, params=params,
                                 field_names=[f"f{i}" for i in range(F)],
                                 batch_size=4, precision="int8")
    want = jax_q8.query_tokens_from_embeddings(fields, mask)
    assert got.shape == want.shape == (9, K, D) and got.dtype == np.float32
    assert _token_cos(got, want).min() >= JAX_ENGINE_COS


@pytest.mark.parametrize("case", ["use_fused_false", "unsupported_config"])
def test_inference_int8_refusals(setup, case):
    cfg, _, sd, _, _ = setup
    kw = _common(cfg, sd)
    if case == "use_fused_false":
        kw["use_fused"] = False
    else:  # K=3 does not divide 256: supports_fused fails
        kw["config"] = dataclasses.replace(cfg, num_query_tokens=3)
    with pytest.raises(ValueError, match="fused"):
        QFormerInference(**kw, precision="int8")


def test_int8_wrappers_refuse_other_devices():
    x = torch.empty(2, K, D, dtype=torch.bfloat16, device="meta")
    w1 = torch.empty(128, D, dtype=torch.int8, device="meta")
    w2 = torch.empty(D, 128, dtype=torch.int8, device="meta")
    s = torch.empty(128, device="meta")
    v = torch.empty(D, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pq.fused_ffn_block_q(x, w1, s, s, w2, v, v, v, v)
