"""The port's CUDA kernels against their plain versions on the card, at the
serving slice's shapes (the comparisons of chip_smoke.py's phase 3).

Marked ``gpu``: each test asks the ``hopper`` fixture, which skips unless a
CUDA device of compute capability 9.0 is present.  Run them on the card with
``python -m pytest tests/test_torch_kernels_gpu.py -q``.
"""

import pytest
import torch

from unirec_tpu_torch.ops.flash_causal import (
    flash_causal_attention,
    flash_causal_attention_plain,
)
from unirec_tpu_torch.ops.losses import l2_normalize
from unirec_tpu_torch.ops.ranking import retrieve_top_k, top_k_items

pytestmark = pytest.mark.gpu


@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper GPU: no CUDA device")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs an NVIDIA Hopper GPU (compute capability 9.0)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_k1_matches_plain(hopper, dtype, tol):
    b, l, hq, hkv, hd = 8, 512, 16, 8, 128
    q = torch.randn(b, l, hq * hd, device="cuda", generator=hopper).to(dtype)
    k = torch.randn(b, l, hkv * hd, device="cuda", generator=hopper).to(dtype)
    v = torch.randn(b, l, hkv * hd, device="cuda", generator=hopper).to(dtype)
    lengths = torch.tensor([1, 7, 64, 65, 200, 333, 511, 512], device="cuda")
    mask = (torch.arange(l, device="cuda")[None] < lengths[:, None]).float()
    before = flash_causal_attention.launches
    out = flash_causal_attention(q, k, v, mask, hq, hkv)
    torch.cuda.synchronize()
    assert flash_causal_attention.launches == before + 1
    ref = flash_causal_attention_plain(q.float(), k.float(), v.float(), mask,
                                       hq, hkv)
    rel = (out.float() - ref).abs().max() / ref.abs().max()
    assert rel <= tol


@pytest.mark.parametrize("n_users", [8, 64])
def test_k2_matches_plain(hopper, n_users):
    users = torch.randn(n_users, 1024, device="cuda", generator=hopper)
    catalog = torch.randn(20_000, 1024, device="cuda", generator=hopper)
    s, i = retrieve_top_k(users, catalog, k=20)
    torch.cuda.synchronize()
    s_ref, i_ref = top_k_items(users, catalog, k=20)
    assert (s - s_ref).abs().max() <= 1e-5
    full = l2_normalize(users) @ l2_normalize(catalog).T
    diff = i != i_ref  # only near-ties (< 1e-6 apart) may swap
    assert ((full.gather(1, i) - s_ref)[diff].abs() < 1e-6).all()
