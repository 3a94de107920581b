"""The item step's forward gate of ``chip_smoke.py`` (phase 7 (a), C-12).

The fused-anchor item step runs on the plain-anchor step's active set of the
contrastive hinge relu(margin + d(a, p) - d(a, n)), and ``hinge_gate``
holds its forward to the plain one sample by sample: the anchor
representation (max|d| / max|ref| <= 2e-2, per-row cosine >= 0.9999) and
each hinge argument within 2 |a_f - a_p| + |p_f - p_p| + |n_f - n_p| of the
reference's, plus both steps' rounding of the distances.  Here on synthetic
representations (a flip inside the bound, an argument outside it, a
representation below the cosine, no flip), the rounding bound against the
float32 arguments, the active set against the hinge's gradient (an argument
of exactly 0 passes it), and one CPU run of phase 7 (a)'s comparison at a
tiny ``ItemQFormerConfig``, where the fused anchor takes its plain
versions.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from tests.torch_dist_ranks import one_torch_thread  # noqa: F401
from unirec_tpu_torch.configs import ItemQFormerConfig
from unirec_tpu_torch.ops.losses import (
    triplet_hinge_active,
    triplet_hinge_arguments,
)
from unirec_tpu_torch.utils.weights import init_item_qformer


B, D, MARGIN = 16, 32, 0.5


def _step(a, p, n):
    """The parity metrics of a step whose anchor, positive and negative
    representations are a, p, n (float32)."""
    return {"hinge_arguments": triplet_hinge_arguments(a, p, n, MARGIN),
            "item_representation": a, "positive_representation": p,
            "negative_representation": n}


def _reps(seed=0):
    g = torch.Generator().manual_seed(seed)
    a, p, n = (torch.randn(B, D, generator=g) for _ in range(3))
    return a, p, n, g


def _near_zero(a, p, n, i, arg=1e-4):
    """Sample i's negative moved along its direction from the anchor so that
    its hinge argument is ``arg``."""
    d_p = (a[i] - p[i]).norm()
    u = (n[i] - a[i]) / (n[i] - a[i]).norm()
    n[i] = a[i] + (d_p + MARGIN - arg) * u


def test_no_flip_passes():
    a, p, n, g = _reps()
    a_f = a + 1e-4 * torch.randn(B, D, generator=g)
    ref, got = _step(a, p, n), _step(a_f, p, n)
    gate = cs.hinge_gate(ref, got)
    assert gate["ok"] and len(gate["flips"]) == 0
    assert gate["rep_cos"] >= cs.ANCHOR_REP_COS
    assert bool((gate["gap"] <= gate["bound"]).all())


def test_a_flip_inside_the_lipschitz_bound_is_admitted():
    a, p, n, _ = _reps(1)
    _near_zero(a, p, n, 0)
    # the fused anchor one small step towards p and away from n
    step = ((p[0] - a[0]) / (p[0] - a[0]).norm()
            - (n[0] - a[0]) / (n[0] - a[0]).norm())
    a_f = a.clone()
    a_f[0] += 1e-3 * step / step.norm()
    ref, got = _step(a, p, n), _step(a_f, p, n)
    assert ref["hinge_arguments"][0] > 0 > got["hinge_arguments"][0]
    gate = cs.hinge_gate(ref, got)
    assert gate["flips"].tolist() == [0]
    assert gate["ok"]
    assert gate["gap"][0] <= 2 * (a_f[0] - a[0]).norm() + 1e-5


def test_an_argument_outside_the_bound_fails():
    a, p, n, g = _reps(2)
    a_f = a + 1e-4 * torch.randn(B, D, generator=g)
    got = _step(a_f, p, n)
    got["hinge_arguments"] = got["hinge_arguments"].clone()
    got["hinge_arguments"][3] += 0.05  # not what its representations give
    gate = cs.hinge_gate(_step(a, p, n), got)
    assert gate["rep_cos"] >= cs.ANCHOR_REP_COS
    assert not gate["ok"]
    assert (gate["gap"] > gate["bound"]).nonzero().flatten().tolist() == [3]


def test_a_representation_below_the_cosine_fails():
    a, p, n, g = _reps(3)
    a[2] *= 0.01  # a short row: its cosine moves, max|d| / max|ref| barely
    noise = torch.randn(D, generator=g)
    noise -= (noise @ a[2]) / (a[2] @ a[2]) * a[2]  # orthogonal to the row
    a_f = a.clone()
    a_f[2] += 0.02 * a[2].norm() * noise / noise.norm()
    gate = cs.hinge_gate(_step(a, p, n), _step(a_f, p, n))
    assert gate["rep_rel"] <= cs.ANCHOR_REP_REL
    assert gate["rep_cos"] < cs.ANCHOR_REP_COS
    assert bool((gate["gap"] <= gate["bound"]).all())
    assert not gate["ok"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rounding_bound_covers_the_computed_arguments(dtype):
    """The arguments as the step computes them (an anchor in ``dtype``
    against float32 positives and negatives, float32 arithmetic) lie within
    ``hinge_rounding`` of the exact arguments of the same inputs."""
    g = torch.Generator().manual_seed(4)
    a = (3.0 * torch.randn(512, 1024, generator=g)).to(dtype)
    p, n = (a.float() + torch.randn(512, 1024, generator=g) for _ in range(2))
    got = triplet_hinge_arguments(a, p, n, MARGIN).double()
    exact = triplet_hinge_arguments(a.double(), p.double(), n.double(), MARGIN)
    err = (got - exact).abs()
    assert bool((err <= cs.hinge_rounding(a, p, n, MARGIN)).all())


def test_phase_7a_on_the_cpu():
    """Phase 7 (a)'s comparison at a tiny size: the plain-anchor step, then
    the fused-anchor step (B12s / B12c's plain versions on the CPU) on its
    active set of the hinge; the forward gate and the gradient gate hold."""
    cfg = ItemQFormerConfig(hidden_size=128, num_hidden_layers=2,
                            num_attention_heads=4, intermediate_size=256,
                            num_query_tokens=8, field_embedding_dim=128,
                            num_fields=5, dropout=0.0)
    sd = init_item_qformer(cfg, torch.Generator().manual_seed(0)).state_dict()
    rng = np.random.default_rng(0)
    batch = {}
    for x in ("anchor", "pos", "neg"):
        mask = (rng.random((8, cfg.num_fields)) > 0.2).astype(np.float32)
        mask[:, 0] = 1.0
        batch[f"{x}_emb"] = (rng.standard_normal(
            (8, cfg.num_fields, cfg.field_embedding_dim), dtype=np.float32)
            * mask[..., None])
        batch[f"{x}_mask"] = mask
    res = cs.item_step_parity(cfg, sd, batch, cs.item_counters(),
                              device="cpu")
    gate = res["gate"]
    assert gate["arg_p"].shape == (8,)
    assert bool((gate["gap"] <= gate["bound"]).all())
    assert res["ok"], cs.hinge_log(res)
    assert not any(res["launches_f"].values())  # the plain versions ran


def test_the_active_set_is_where_the_hinge_passes_the_gradient():
    """The reference's active set, which the fused step takes, is where the
    plain step's hinge (``clamp(arg, min=0)`` in ``triplet_margin_loss``)
    passes each sample's gradient: an argument of exactly 0 is in it."""
    a, p, n, _ = _reps(5)
    arg = triplet_hinge_arguments(a, p, n, MARGIN)
    assert bool((arg > 0).any() and (arg < 0).any())
    arg = torch.cat([arg, torch.tensor([0.0, -0.0])]).requires_grad_()
    torch.clamp(arg, min=0.0).sum().backward()
    assert torch.equal(triplet_hinge_active(arg.detach()), arg.grad)
    assert triplet_hinge_active(arg.detach())[-2:].tolist() == [1.0, 1.0]
