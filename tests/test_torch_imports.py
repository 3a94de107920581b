"""The port imports torch and never JAX or Flax, and builds nothing at import
time; its kernel wrappers take the plain versions for CPU tensors and leave
their launch counters at 0."""

import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import unirec_tpu_torch
names = ["unirec_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(unirec_tpu_torch.__path__,
                                          "unirec_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "triton"))
import json
print(json.dumps({"modules": len(names), "framework": bad}))
"""


def test_fresh_import_loads_no_jax_or_flax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["modules"] >= 15  # every module of the package imported
    assert result["framework"] == []


def test_cpu_wrappers_use_plain_versions():
    from unirec_tpu_torch.ops import _build
    from unirec_tpu_torch.ops.flash_causal import flash_causal_attention
    from unirec_tpu_torch.ops.ranking import retrieve_top_k

    flash_causal_attention.launches = 0
    retrieve_top_k.launches = 0
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 8, 2 * 128, generator=gen)
    kv = torch.randn(1, 8, 128, generator=gen)
    out = flash_causal_attention(q, kv, kv, torch.ones(1, 8), 2, 1)
    s, i = retrieve_top_k(torch.randn(3, 16, generator=gen),
                          torch.randn(50, 16, generator=gen), k=5)
    assert out.shape == q.shape and s.shape == i.shape == (3, 5)
    assert flash_causal_attention.launches == 0
    assert retrieve_top_k.launches == 0
    # nothing was compiled or loaded for CPU tensors
    assert _build.load_kernels.cache_info().currsize == 0
