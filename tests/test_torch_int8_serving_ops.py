"""Port parity: the int8 (W8A8) Qwen3 serving forward, unirec_tpu_torch
(plain versions on the CPU) vs unirec_tpu (Pallas kernels in interpret mode,
the XLA int8 formula and the Flax model).

Kernels: B8 (``int8_linear``) and B9a (``qkv_int8``) bit for bit: both sides
quantize rows as the jitted JAX kernel does (codes ``round(x *
fl(127/absmax))``, scale ``absmax * fl(1/127)``), the integer products are
exact and the epilogue rounds at the same points.  B9b (``swiglu_mlp_int8``):
per-row cosine >= 0.99999 and max|d| <= 1e-3 max|ref|, because torch's and
XLA's sigmoid differ in the last ulp, which can move one code of ``h``.  The
STE forwards bit for bit, their input gradients atol 1e-6 (fp32 matmuls
summed in another order).  Weight quantization bit for bit; the LoRA merge
atol 1e-6 (the [in, r] x [r, out] product in another order).

Models: hidden 128, intermediate 256, 2 layers, one head of 128 (the
``tests/test_fused_qwen3.py`` configuration), batch 8 x length 64 = 512 rows
so that the fused guards pass.  Per-row cosine against the JAX model: the
fp32 sums between the projections (RMSNorm, attention) run in another order
in the two frameworks, so an input to a quantization can differ by an ulp and
move one int8 code.  Per projection and in fused training (B9a under LoRA)
every row keeps cosine >= 0.9999.  In fused inference B9b requantizes the
whole SwiGLU output ``h`` per row, and one step of an ``h`` code is about 1%
of that row's largest MLP output: there every row keeps >= 0.99 and the mean
over rows >= 0.9999.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_dist_ranks import one_torch_thread  # noqa: F401
from unirec_tpu.configs import LoRAConfig, Qwen3Config
from unirec_tpu.models import qwen3 as jq
from unirec_tpu.ops import fused_qwen3_int8 as jf
from unirec_tpu.ops.fused_qformer_int8 import quantize_weight as jax_qw
from unirec_tpu.ops.int8_matmul import int8_linear as jax_int8_linear
from unirec_tpu.ops.int8_ste import int8_linear_ste as jax_ste
from unirec_tpu.utils.params import merge_lora_weights as jax_merge
from unirec_tpu_torch.models import qwen3 as pq
from unirec_tpu_torch.ops import fused_qwen3_int8 as pf
from unirec_tpu_torch.ops.int8_matmul import (
    int8_linear,
    int8_linear_plain,
    kernel_row_quant,
    supports_int8_linear,
)
from unirec_tpu_torch.ops.int8_ste import int8_linear_ste
from unirec_tpu_torch.utils.params import merge_lora_weights, merged_model
from unirec_tpu_torch.utils.weights import (
    flax_to_state_dict,
    init_joint,
    qweights_from_flax,
)
from tests.test_torch_joint import JC, LORA, QF, QWEN, randomize_lora_b


D, INTER, ROWS = 128, 256, 512
MLP_COS, MLP_REL = 0.99999, 1e-3
GRAD_ATOL = 1e-6
MODEL_COS = 0.9999
FUSED_MIN_COS, FUSED_MEAN_COS = 0.99, 0.9999


def _quant_cols(rng, k, n, scale=0.05):
    """JAX per-column weight codes: [K, N] int8 and [N] scales (numpy)."""
    kq, ks = jax_qw(jnp.asarray(rng.randn(k, n).astype(np.float32) * scale))
    return np.asarray(kq), np.asarray(ks).reshape(-1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _row_cos(a, b):
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1) + 1e-30)


# -- B8 -------------------------------------------------------------------------


@pytest.mark.parametrize("out", ["fp32", "bf16"])
def test_int8_linear_plain_matches_jax_kernel(out):
    rng = np.random.RandomState(0)
    x = (rng.randn(ROWS, 256) * 3.0).astype(np.float32)
    x[7] = 0.0  # a row below the 1e-6 floor
    x[9, 3] = 40.0  # a code at exactly +-127
    kq, ks = _quant_cols(rng, 256, 512)
    jdt, tdt = ((jnp.float32, torch.float32) if out == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    want = jax_int8_linear(jnp.asarray(x), jnp.asarray(kq), jnp.asarray(ks),
                           out_dtype=jdt, interpret=True)
    got = int8_linear_plain(_t(x), _t(kq.T), _t(ks), tdt)
    assert got.dtype == tdt and got.shape == (ROWS, 512)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    # the wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(int8_linear(_t(x), _t(kq.T), _t(ks),
                                              tdt).float().numpy(),
                                  got.float().numpy())


def test_kernel_row_quant_is_the_jitted_jax_form():
    """Inside jit XLA turns ``absmax / 127.0`` into a multiply by fl(1/127);
    the codes are ``x * fl(127 / absmax)`` either way."""
    from unirec_tpu.ops.fused_qformer_int8 import _row_quant

    rng = np.random.RandomState(4)
    x = (rng.randn(64, 96) * rng.uniform(1e-3, 30.0, (64, 1))).astype(
        np.float32)
    jcodes, jscale = jax.jit(_row_quant)(jnp.asarray(x))
    codes, scale = kernel_row_quant(_t(x))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))


def test_supports_int8_linear():
    assert supports_int8_linear(4096, 1024, 2048)
    assert supports_int8_linear(1, 16, 8)  # no row threshold on the card
    assert not supports_int8_linear(0, 1024, 2048)
    assert not supports_int8_linear(512, 1000, 512)  # K: whole 16-byte rows
    assert not supports_int8_linear(512, 1024, 500)  # N: pairs of columns


# -- the STE linears ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_int8_linear_ste_matches_jax(dtype):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 8, 64).astype(np.float32)
    kq, ks = _quant_cols(rng, 64, 48)
    r = rng.randn(2, 8, 48).astype(np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    jx = jnp.asarray(x).astype(jdt)
    want = jax.jit(jax_ste)(jx, jnp.asarray(kq), jnp.asarray(ks))
    xt = _t(x).to(tdt).requires_grad_(True)
    got = int8_linear_ste(xt, _t(kq.T), _t(ks))
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    if dtype == "fp32":
        gx = jax.grad(lambda v: jnp.sum(jax_ste(v, jnp.asarray(kq),
                                                jnp.asarray(ks)) * r))(jx)
        (got * _t(r)).sum().backward()
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx),
                                   atol=GRAD_ATOL, rtol=0)


def test_int8_linear_ste_row_scale_is_the_jitted_form():
    """The per-projection int8 forward off the TPU (C-18): under jit, as
    every JAX caller runs it, XLA computes the row scale ``absmax / 127.0``
    as ``absmax * fl(1 / 127)``; rows where that is not the quotient get
    other dequantized outputs (and, near a rounding boundary, other codes)
    from the quotient form.  Bit for bit against the jitted JAX function,
    over rows that include such scales."""
    rng = np.random.RandomState(11)
    x = (rng.randn(256, 64) * rng.uniform(1e-3, 30.0, (256, 1))).astype(
        np.float32)
    absmax = np.maximum(np.abs(x).max(1), np.float32(1e-6))
    assert (absmax / np.float32(127.0)
            != absmax * np.float32(1.0 / 127.0)).sum() >= 10
    kq, ks = _quant_cols(rng, 64, 48)
    want = jax.jit(jax_ste)(jnp.asarray(x), jnp.asarray(kq), jnp.asarray(ks))
    got = int8_linear_ste(_t(x), _t(kq.T), _t(ks))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int8_linear_fused_ste_matches_jax():
    rng = np.random.RandomState(2)
    x = (rng.randn(ROWS, D) * 0.3).astype(np.float32)
    kq, ks = _quant_cols(rng, D, 3 * D)
    r = rng.randn(ROWS, 3 * D).astype(np.float32)
    want = jf.int8_linear_fused_ste(jnp.asarray(x), jnp.asarray(kq),
                                    jnp.asarray(ks))
    xt = _t(x).requires_grad_(True)
    got = pf.int8_linear_fused_ste(xt, _t(kq.T), _t(ks))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    gx = jax.grad(lambda v: jnp.sum(jf.int8_linear_fused_ste(
        v, jnp.asarray(kq), jnp.asarray(ks)) * r))(jnp.asarray(x))
    (got * _t(r)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx),
                               atol=GRAD_ATOL, rtol=0)


# -- B9a, B9b ------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_qkv_int8_plain_matches_jax_kernel(dtype):
    rng = np.random.RandomState(3)
    x = (rng.randn(ROWS, D) * 0.3).astype(np.float32)
    kq, ks = _quant_cols(rng, D, 3 * D)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    want = jf.qkv_int8(jnp.asarray(x).astype(jdt), jnp.asarray(kq),
                       jnp.asarray(ks), interpret=True)
    got = pf.qkv_int8(_t(x).to(tdt), _t(kq.T), _t(ks))
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("scale", [0.3, 3.0])
def test_swiglu_mlp_int8_plain_matches_jax_kernel(scale):
    rng = np.random.RandomState(5)
    x = (rng.randn(ROWS, D) * scale).astype(np.float32)
    gq, gs = _quant_cols(rng, D, INTER)
    uq, us = _quant_cols(rng, D, INTER)
    dq, ds = _quant_cols(rng, INTER, D)
    wgu, sgu = np.concatenate([gq, uq], 1), np.concatenate([gs, us])
    want = np.asarray(jf.swiglu_mlp_int8(
        jnp.asarray(x), jnp.asarray(wgu), jnp.asarray(sgu), jnp.asarray(dq),
        jnp.asarray(ds), interpret=True))
    got = pf.swiglu_mlp_int8(_t(x), _t(wgu.T), _t(sgu), _t(dq.T),
                             _t(ds)).numpy()
    assert _row_cos(got, want).min() >= MLP_COS
    assert np.abs(got - want).max() <= MLP_REL * np.abs(want).max()


def test_supports_fused_qwen3_is_the_jax_guard():
    for args in [(512, 128, 256), (500, 128, 256), (512, 96, 256),
                 (512, 128, 200), (1024, 1024, 0), (4096, 1024, 3072)]:
        assert pf.supports_fused_qwen3(*args) == jf.supports_fused_qwen3(
            *args)
    with pytest.raises(ValueError, match="multiple of 512"):
        pf.qkv_int8(torch.zeros(500, D), torch.zeros(3 * D, D,
                                                     dtype=torch.int8),
                    torch.ones(3 * D))


# -- weights -------------------------------------------------------------------------


def _aligned_cfg(**kw):
    return Qwen3Config(
        vocab_size=512, hidden_size=D, intermediate_size=INTER,
        num_hidden_layers=2, num_attention_heads=1, num_key_value_heads=1,
        head_dim=128, max_position_embeddings=64, flash_attention=False,
        **kw)


@pytest.fixture(scope="module")
def qwen_setup():
    """Flax params (LoRA r=4 with nonzero lora_b), inputs, and the port
    model over the same weights."""
    lora = LoRAConfig(r=4, alpha=8, dropout=0.0)
    cfg = _aligned_cfg()
    rng = np.random.RandomState(6)
    ids = rng.randint(0, cfg.vocab_size, (8, 64)).astype(np.int32)
    mask = np.ones((8, 64), np.float32)
    mask[3, 40:] = 0.0
    params = randomize_lora_b(jq.Qwen3Model(cfg, lora=lora).init(
        jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask)))
    return cfg, lora, params, ids, mask


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_quantize_qwen3_weights_matches_jax(qwen_setup, dtype):
    """The weights as stored, upcast: a bf16 model quantizes as a tree
    passed through cast_frozen_to_bf16 does."""
    cfg, lora, params, _, _ = qwen_setup
    tree = params["params"]
    sd = flax_to_state_dict(params)
    if dtype == "bf16":
        tree = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.bfloat16), tree)
        sd = {k: v.bfloat16() for k, v in sd.items()}
    want = qweights_from_flax(jq.quantize_qwen3_weights(tree))
    got = pq.quantize_qwen3_weights(sd)
    assert set(got) == set(want)
    assert len(got) == cfg.num_hidden_layers * 7 * 2
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        np.testing.assert_array_equal(got[key].numpy(), value.numpy(),
                                      err_msg=key)
    if dtype == "fp32":  # a model gives what its state_dict gives
        pm = pq.Qwen3Model(cfg, lora=lora)
        pm.load_state_dict(sd)
        for key, value in pq.quantize_qwen3_weights(pm).items():
            assert torch.equal(value, got[key]), key


def test_merge_lora_weights_matches_jax(qwen_setup):
    cfg, lora, params, _, _ = qwen_setup
    want = flax_to_state_dict({"params": jax_merge(params["params"],
                                                   lora.scaling)})
    sd = flax_to_state_dict(params)
    got = merge_lora_weights(sd, lora.scaling)
    assert set(got) == set(want)
    assert not any(k.endswith(("lora_a", "lora_b")) for k in got)
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), value.numpy(),
                                   atol=1e-6, rtol=0, err_msg=key)
    # unmerged entries are the same tensors
    assert got["layers.0.input_layernorm.weight"] is sd[
        "layers.0.input_layernorm.weight"]


# -- models ---------------------------------------------------------------------------


def _jax_hidden(cfg, lora, params, ids, mask, **flags):
    model = jq.Qwen3Model(dataclasses.replace(cfg, **flags), lora=lora)
    qw = jq.quantize_qwen3_weights(params["params"])
    return np.asarray(model.apply({"params": params["params"], "qweights": qw},
                                  jnp.asarray(ids), jnp.asarray(mask),
                                  deterministic=True), np.float32)


def _port_model(cfg, lora, params, **flags):
    pm = pq.Qwen3Model(dataclasses.replace(cfg, **flags), lora=lora)
    pm.load_state_dict(flax_to_state_dict(params))
    pq.set_qweights(pm, pq.quantize_qwen3_weights(pm))
    return pm


def _count_launch_free(fn):
    """CPU tensors take the plain versions: no wrapper counts a launch."""
    before = (int8_linear.launches, pf.qkv_int8.launches,
              pf.swiglu_mlp_int8.launches)
    out = fn()
    assert (int8_linear.launches, pf.qkv_int8.launches,
            pf.swiglu_mlp_int8.launches) == before
    return out


def test_qwen3_int8_per_projection_matches_jax(qwen_setup):
    cfg, lora, params, ids, mask = qwen_setup
    want = _jax_hidden(cfg, lora, params, ids, mask)
    pm = _port_model(cfg, lora, params)
    with torch.no_grad():
        got = _count_launch_free(lambda: pm(_t(ids).long(), _t(mask)).numpy())
    assert _row_cos(got, want).min() >= MODEL_COS


def test_qwen3_int8_fused_inference_matches_jax(qwen_setup, monkeypatch):
    """lora=None (merged), fused_int8_inference at 512 rows: q|k|v through
    B9a and the MLP through B9b in both packages."""
    cfg, lora, params, ids, mask = qwen_setup
    merged = {"params": jax_merge(params["params"], lora.scaling)}
    want = _jax_hidden(cfg, None, merged, ids, mask,
                       fused_int8_inference=True)
    pm = _port_model(cfg, None, merged, fused_int8_inference=True)
    calls = []
    for name in ("qkv_int8", "swiglu_mlp_int8"):
        fn = getattr(pq, name)
        monkeypatch.setattr(pq, name, lambda *a, _f=fn, _n=name:
                            calls.append(_n) or _f(*a))
    with torch.no_grad():
        got = pm(_t(ids).long(), _t(mask)).numpy()
    assert calls.count("qkv_int8") == calls.count("swiglu_mlp_int8") == 2
    cos = _row_cos(got, want)
    assert cos.min() >= FUSED_MIN_COS and cos.mean() >= FUSED_MEAN_COS
    # a ragged batch (7 x 64 rows) misses the guard and runs per projection
    calls.clear()
    with torch.no_grad():
        pm(_t(ids[:7]).long(), _t(mask[:7]))
    assert calls == []


def test_qwen3_int8_fused_training_matches_jax(qwen_setup):
    """fused_int8_training with live LoRA: forward and the LoRA gradients
    against jax.grad through the same path."""
    cfg, lora, params, ids, mask = qwen_setup
    flags = dict(fused_int8_training=True)
    want = _jax_hidden(cfg, lora, params, ids, mask, **flags)
    qw = jq.quantize_qwen3_weights(params["params"])
    jm = jq.Qwen3Model(dataclasses.replace(cfg, **flags), lora=lora)

    # a fixed random projection of the output: sum(out ** 2) would read
    # RMS-normed rows, whose gradient before the final norm nearly cancels
    r = np.random.RandomState(7).randn(*ids.shape, D).astype(np.float32)

    def loss(p):
        out = jm.apply({"params": p, "qweights": qw}, jnp.asarray(ids),
                       jnp.asarray(mask), deterministic=True)
        return jnp.sum(out.astype(jnp.float32) * r)

    jgrads = flax_to_state_dict({"params": jax.grad(loss)(params["params"])})
    pm = _port_model(cfg, lora, params, **flags)
    out = pm(_t(ids).long(), _t(mask))
    assert _row_cos(out.detach().numpy(), want).min() >= MODEL_COS
    (out.float() * _t(r)).sum().backward()
    checked = 0
    for name, p in pm.named_parameters():
        if name.endswith(("lora_a", "lora_b")):
            g, w = p.grad.numpy().ravel(), jgrads[name].numpy().ravel()
            cos = (g * w).sum() / (np.linalg.norm(g) * np.linalg.norm(w))
            assert cos > 0.999, (name, cos)
            checked += 1
        elif name.endswith(("proj.weight")):
            assert p.grad is None  # frozen int8 base: no weight gradient
    assert checked == cfg.num_hidden_layers * 7 * 2


def test_set_qweights_concatenates_and_detaches(qwen_setup):
    cfg, lora, params, _, _ = qwen_setup
    pm = _port_model(cfg, None, {"params": jax_merge(params["params"],
                                                     lora.scaling)})
    attn, mlp = pm.layers[0].self_attn, pm.layers[0].mlp
    assert attn.qkv_q.shape == (cfg.q_size + 2 * cfg.kv_size, D)
    assert attn.k_proj.weight_q.data_ptr() == (attn.qkv_q.data_ptr()
                                               + cfg.q_size * D)
    assert mlp.gate_up_q.shape == (2 * INTER, D)
    assert not any("weight_q" in k or "qkv" in k for k in pm.state_dict())
    pq.set_qweights(pm, None)
    assert attn.qkv_q is None and attn.q_proj.weight_q is None
    with pytest.raises(KeyError):
        pq.set_qweights(pm, {"layers.0.nope.weight_q": torch.zeros(1)})


def test_merged_model_leaves_the_caller_alone():
    gen = torch.Generator().manual_seed(0)
    pm = init_joint(QWEN, QF, JC, LORA, gen, lora_b_std=0.2)
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    merged = merged_model(pm)
    assert merged.lora is None and pm.lora is LORA
    assert not any("lora" in k for k in merged.state_dict())
    for k, v in pm.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    name = "base_model.layers.0.self_attn.q_proj.weight"
    assert not torch.equal(merged.state_dict()[name], pm.state_dict()[name])
    assert (merged.state_dict()["base_model.embed_tokens"].data_ptr()
            == pm.state_dict()["base_model.embed_tokens"].data_ptr())
    assert merged_model(merged) is merged
