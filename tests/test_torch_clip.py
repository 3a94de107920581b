"""Port parity: the CLIP towers and the CLIP image backend, unirec_tpu_torch
vs unirec_tpu (and vs Hugging Face ``CLIPModel``) on the CPU.

Tiny configs (2 layers, width 32, 28-pixel images of 14-pixel patches).  The
JAX towers' weights go through ``utils/weights.clip_state_dict_from_flax``
(the patch convolution's kernel transposed to NCHW, the token table
renamed); in float32 the port's towers give the JAX outputs within
max|d| / max|ref| <= 1e-5.  An HF ``CLIPModel`` built in the test goes
through the port's ``convert_clip_vision`` / ``convert_clip_text`` and the
bridge: its image and text features within 1e-4.  ``preprocess_image``
gives the JAX function's arrays on the same PIL image, and
``CLIPImageBackend`` the JAX backend's rows for a path, a base64 string, a
PIL image and a reference that does not load (a zero row).
"""

import base64
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from unirec_tpu.encoders import backends as jax_backends
from unirec_tpu.models import clip as jax_clip
from unirec_tpu_torch.encoders.backends import CLIPImageBackend, CLIPTextBackend
from unirec_tpu_torch.models import clip
from unirec_tpu_torch.utils.weights import (
    clip_state_dict_from_flax,
    init_clip_text,
    init_clip_vision,
)

VC = clip.CLIPVisionConfig(hidden_size=32, intermediate_size=64,
                           num_hidden_layers=2, num_attention_heads=4,
                           image_size=28, patch_size=14, projection_dim=16)
TC = clip.CLIPTextConfig(vocab_size=100, hidden_size=32, intermediate_size=64,
                         num_hidden_layers=2, num_attention_heads=4,
                         max_position_embeddings=16, projection_dim=16,
                         eos_token_id=99)
REL = 1e-5


def rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _jax_vision(seed=0):
    model = jax_clip.CLIPVisionTower(VC)
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, VC.image_size, VC.image_size, 3)))
    return model, params


def _port(cls, cfg, params):
    model = cls(cfg).eval()
    model.load_state_dict(clip_state_dict_from_flax(params))
    return model


def test_vision_tower_matches_jax():
    jm, params = _jax_vision()
    pix = np.random.RandomState(1).randn(3, 28, 28, 3).astype(np.float32)
    want = np.asarray(jm.apply(params, jnp.asarray(pix)))
    with torch.no_grad():
        got = _port(clip.CLIPVisionTower, VC, params)(torch.from_numpy(pix))
    assert got.shape == (3, VC.projection_dim) and got.dtype == torch.float32
    assert rel_err(got.numpy(), want) <= REL


@pytest.mark.parametrize("eos", [99, None], ids=["first_eos", "argmax_id"])
def test_text_tower_matches_jax(eos):
    cfg = dataclasses.replace(TC, eos_token_id=eos)
    rng = np.random.RandomState(2)
    ids = rng.randint(1, 90, (4, 12)).astype(np.int32)
    ids[0, 5] = ids[0, 9] = 99  # two eos: the first pools (HF)
    ids[1, -1] = 99
    ids[2, 3] = 99
    mask = np.ones((4, 12), np.float32)
    mask[2, 4:] = 0.0  # padded after its eos
    jm = jax_clip.CLIPTextTower(cfg)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(ids))
    want = np.asarray(jm.apply(params, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = _port(clip.CLIPTextTower, cfg, params)(torch.from_numpy(ids),
                                                     torch.from_numpy(mask))
    assert rel_err(got.numpy(), want) <= REL


def test_quick_gelu_matches_jax():
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    np.testing.assert_allclose(clip.quick_gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_clip.quick_gelu(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


def _hf_clip():
    from transformers import CLIPConfig, CLIPModel

    cfg = CLIPConfig(
        text_config=dict(
            vocab_size=TC.vocab_size, hidden_size=TC.hidden_size,
            intermediate_size=TC.intermediate_size,
            num_hidden_layers=TC.num_hidden_layers,
            num_attention_heads=TC.num_attention_heads,
            max_position_embeddings=TC.max_position_embeddings,
            eos_token_id=99, bos_token_id=98),
        vision_config=dict(
            hidden_size=VC.hidden_size, intermediate_size=VC.intermediate_size,
            num_hidden_layers=VC.num_hidden_layers,
            num_attention_heads=VC.num_attention_heads,
            image_size=VC.image_size, patch_size=VC.patch_size),
        projection_dim=VC.projection_dim)
    torch.manual_seed(0)
    return CLIPModel(cfg).eval()


def test_towers_match_hf_through_the_converters():
    hf = _hf_clip()
    vc, tc = clip.vision_config_from_hf(hf.config), clip.text_config_from_hf(
        hf.config)
    assert (vc, tc) == (VC, TC)
    sd = hf.state_dict()
    vision = _port(clip.CLIPVisionTower, VC, clip.convert_clip_vision(sd, VC))
    text = _port(clip.CLIPTextTower, TC, clip.convert_clip_text(sd, TC))
    rng = np.random.RandomState(4)
    pix = rng.randn(2, 3, 28, 28).astype(np.float32)
    ids = rng.randint(1, 98, (2, 12))
    ids[:, -1] = 99
    with torch.no_grad():
        want_img = hf.get_image_features(pixel_values=torch.from_numpy(pix))
        want_txt = hf.get_text_features(input_ids=torch.from_numpy(ids))
        got_img = vision(torch.from_numpy(pix.transpose(0, 2, 3, 1)))
        got_txt = text(torch.from_numpy(ids))
    assert rel_err(got_img.numpy(), want_img.numpy()) <= 1e-4
    assert rel_err(got_txt.numpy(), want_txt.numpy()) <= 1e-4


def test_preprocess_image_matches_jax():
    rng = np.random.RandomState(5)
    for h, w in ((50, 70), (30, 30), (90, 41)):
        img = Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8))
        got = clip.preprocess_image(img, 28)
        assert got.shape == (28, 28, 3)
        np.testing.assert_array_equal(got, jax_clip.preprocess_image(img, 28))


def test_image_backend_matches_jax(tmp_path):
    """Rows for a file path, a base64 string, a data URL and a PIL image;
    a missing file and an empty reference give zero rows."""
    jm, params = _jax_vision(seed=6)
    rng = np.random.RandomState(7)
    images = [Image.fromarray((rng.rand(40 + 7 * i, 33, 3) * 255).astype(
        np.uint8)) for i in range(4)]
    images[0].save(tmp_path / "a.png")
    buf = io.BytesIO()
    images[1].save(buf, format="PNG")
    b64 = base64.b64encode(buf.getvalue()).decode()
    refs = [str(tmp_path / "a.png"), b64, "data:image/png;base64," + b64,
            images[3], str(tmp_path / "missing.png"), ""]
    jb = jax_backends.CLIPImageBackend(VC, params, batch_size=2,
                                       dtype=jnp.float32)
    pb = CLIPImageBackend(VC, clip_state_dict_from_flax(params), batch_size=2,
                          dtype=torch.float32, device="cpu")
    want, got = jb.encode(refs), pb.encode(refs)
    assert got.shape == (6, VC.projection_dim) and got.dtype == np.float32
    assert not got[4:].any() and not want[4:].any()
    assert np.abs(got[:4]).sum(1).min() > 0
    assert rel_err(got, want) <= REL


def test_seeded_towers_and_text_backend():
    """The seeded initialisers draw finite towers of the Flax distributions'
    scale, and ``CLIPTextBackend`` pads to its 77-token length."""
    gen = torch.Generator().manual_seed(0)
    vision = init_clip_vision(VC, gen)
    text = init_clip_text(TC, gen)
    assert torch.equal(vision.pre_layrnorm.weight, torch.ones(VC.hidden_size))
    std = vision.layer[0].fc1.weight.std().item()
    assert 0.5 / VC.hidden_size ** 0.5 < std < 1.5 / VC.hidden_size ** 0.5
    assert abs(vision.position_embedding.std().item() - 0.02) < 0.005

    class Tok:
        def __call__(self, texts, max_length, **kw):
            ids = np.zeros((len(texts), max_length), np.int64)
            for i, t in enumerate(texts):
                row = [1 + len(w) for w in t.split()] + [99]
                ids[i, :len(row)] = row
            return {"input_ids": ids, "attention_mask": (ids > 0).astype(
                np.int64)}

    backend = CLIPTextBackend(TC, text.state_dict(), Tok(), max_length=16,
                              device="cpu")
    out = backend.encode(["a bb ccc", "dddd"])
    assert out.shape == (2, TC.projection_dim) and np.isfinite(out).all()
    ids = Tok()(["a bb ccc", "dddd"], 16)
    with torch.no_grad():
        want = text(torch.from_numpy(ids["input_ids"]),
                    torch.from_numpy(ids["attention_mask"]).float())
    np.testing.assert_array_equal(out, want.numpy())
