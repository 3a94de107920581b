"""The port's field encoders and cache precompute against the JAX package's:
the hash backends bit for bit, the MWNE number encoder (eval and train mode,
weights bridged from Flax variables or read from a reference-schema
checkpoint dict), ``ItemEncoder.encode_batch_by_field``, ``analyze_fields``
and ``build_cache``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_dist_ranks import one_torch_thread  # noqa: F401
from unirec_tpu.configs import MWNEConfig as JaxMWNEConfig
from unirec_tpu.data import cache as jax_cache
from unirec_tpu.encoders import backends as jax_backends
from unirec_tpu.encoders.item_encoder import ItemEncoder as JaxItemEncoder
from unirec_tpu.models.mwne import NormalizedMathematicalEncoder as JaxMWNE
from unirec_tpu.utils.torch_convert import export_mwne
from unirec_tpu_torch.configs import MWNEConfig
from unirec_tpu_torch.data import cache as port_cache
from unirec_tpu_torch.encoders import backends
from unirec_tpu_torch.encoders.item_encoder import ItemEncoder
from unirec_tpu_torch.models.mwne import NormalizedMathematicalEncoder
from unirec_tpu_torch.utils.torch_convert import convert_mwne
from unirec_tpu_torch.utils.weights import mwne_state_dict_from_flax


NUMBERS = [0.5, 1.0, 2.0, 5.0, 10.0, -3.0, 42.0, 100.0, 0.0, "n/a", None,
           "7.25"]
SMALL = dict(embedding_dim=128, num_frequencies=8, max_frequency=50.0)


@pytest.fixture(scope="module")
def mwne():
    """A JAX number encoder of the reference's width with non-trivial
    weights, and the same encoder's port state_dict."""
    cfg = JaxMWNEConfig()
    model = JaxMWNE(cfg)
    variables = jax.tree_util.tree_map(
        np.asarray, model.init(jax.random.PRNGKey(3), jnp.zeros((2,))))
    rng = np.random.RandomState(0)
    base = variables["params"]["base"]
    base["fourier_weight"] = (1 + 0.1 * rng.randn(*base["fourier_weight"].shape)
                              ).astype(np.float32)
    base["raw_scale"] = np.asarray([0.7, 1.3], np.float32)
    variables["batch_stats"]["running_std"] = (
        0.5 + rng.rand(cfg.embedding_dim)).astype(np.float32)
    return cfg, variables


def test_hash_backends_bit_for_bit():
    texts = ["serum", "lip balm", "", "Ünïcode ✓", "42"]
    np.testing.assert_array_equal(backends.HashTextBackend(64).encode(texts),
                                  jax_backends.HashTextBackend(64).encode(texts))
    refs = ["http://x/a.jpg", "b.png", "c"]
    np.testing.assert_array_equal(
        backends.HashImageBackend(768).encode(refs),
        jax_backends.HashImageBackend(768).encode(refs))


def test_mwne_backend_from_flax_variables_and_reference_dict(mwne):
    cfg, variables = mwne
    want = jax_backends.MWNENumberBackend(cfg, variables).encode(NUMBERS)
    port_cfg = MWNEConfig()
    via_flax = backends.MWNENumberBackend(
        port_cfg, mwne_state_dict_from_flax(variables), device="cpu")
    got = via_flax.encode(NUMBERS)
    assert got.shape == (len(NUMBERS), cfg.embedding_dim)
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=1e-5)
    # the reference schema (running statistics restart at their init values,
    # as the reference's load_trained_encoder wraps a fresh normalizer)
    ref_cfg, ref_vars = convert_mwne(export_mwne(cfg, variables))
    assert ref_cfg == port_cfg
    fresh = jax.tree_util.tree_map(np.asarray, variables)
    fresh["batch_stats"] = {"running_std": np.ones(cfg.embedding_dim,
                                                   np.float32),
                            "num_batches_tracked": np.zeros((), np.int32)}
    want_ref = jax_backends.MWNENumberBackend(cfg, fresh).encode(NUMBERS)
    got_ref = backends.MWNENumberBackend(
        ref_cfg, mwne_state_dict_from_flax(ref_vars), device="cpu").encode(
            NUMBERS)
    np.testing.assert_allclose(got_ref, want_ref, atol=2e-6, rtol=1e-5)


def test_mwne_train_mode_updates_running_stats_as_jax():
    cfg = JaxMWNEConfig(**SMALL)
    jm = JaxMWNE(cfg)
    variables = jm.init(jax.random.PRNGKey(1), jnp.zeros((2,)))
    port = NormalizedMathematicalEncoder(MWNEConfig(**SMALL))
    port.load_state_dict(mwne_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables)))
    rng = np.random.RandomState(1)
    state = variables
    for step in range(3):
        x = (rng.randn(64) * (step + 1)).astype(np.float32)
        want, upd = jm.apply(state, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
        state = {"params": variables["params"], **upd}
        got = port(torch.tensor(x), train=True)
        # float32 cos / sin of phases up to ~1500 rad in two libraries
        # (an ulp of the phase is ~1e-4 rad), scaled by up to 10
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-5)
        np.testing.assert_allclose(port.running_std.numpy(),
                                   np.asarray(upd["batch_stats"]["running_std"]),
                                   rtol=1e-5)
    assert int(port.num_batches_tracked) == 3


def _items():
    return [
        {"item_id": "a", "title": "Rose lip balm", "price": 9.5,
         "main_image": "http://img/a.jpg", "store": "Acme"},
        {"item_id": "b", "title": "", "price": "n/a", "average_rating": 4.2},
        {"item_id": "c", "description": "travel size serum", "price": 120,
         "rating_number": 3, "color": None, "unknown_field": "x"},
        {"item_id": "d", "title": "Matte gloss", "main_image": ""},
    ]


def _encoders(mwne):
    cfg, variables = mwne
    number = backends.MWNENumberBackend(MWNEConfig(),
                                        mwne_state_dict_from_flax(variables))
    jnumber = jax_backends.MWNENumberBackend(cfg, variables)
    return (ItemEncoder(number_backend=number),
            JaxItemEncoder(number_backend=jnumber))


def test_item_encoder_encode_batch_by_field(mwne):
    port, jax_enc = _encoders(mwne)
    items = _items()
    fields = port_cache.analyze_fields(items)
    assert fields == jax_cache.analyze_fields(items)
    got = port.encode_batch_by_field(items, fields)
    want = jax_enc.encode_batch_by_field(items, fields)
    assert list(got) == list(want) == fields
    for f in fields:
        np.testing.assert_allclose(got[f], want[f], atol=2e-6, rtol=1e-5,
                                   err_msg=f)
    assert not got["unknown_field"].any() and not got["title"][1].any()


def test_build_cache_matches_jax_and_reloads(mwne, tmp_path):
    port, jax_enc = _encoders(mwne)
    items = _items()
    got = port_cache.build_cache(items, port, cache_dir=str(tmp_path / "p"),
                                 batch_size=3)
    want = jax_cache.build_cache(items, jax_enc, batch_size=3)
    assert got.fields == want.fields and got.item_ids == want.item_ids
    np.testing.assert_array_equal(got.masks, want.masks)
    np.testing.assert_allclose(got.embeddings, want.embeddings, atol=2e-6,
                               rtol=1e-5)
    # an existing cache for the same fields is loaded, not recomputed
    again = port_cache.build_cache(items, None, cache_dir=str(tmp_path / "p"))
    np.testing.assert_array_equal(np.asarray(again.embeddings), got.embeddings)


def test_default_item_encoder_runs_on_the_cpu():
    enc = ItemEncoder()
    out = enc.encode_batch_by_field(_items(), ["price", "title"])
    assert out["price"].shape == (4, 1024) and enc.number_backend.device.type \
        == "cpu"
    norms = np.linalg.norm(out["price"], axis=1)
    np.testing.assert_allclose(norms, 1.0, rtol=1e-5)
