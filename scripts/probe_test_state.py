"""A pytest plugin that looks for state one test file leaves behind for the
next file in the same worker: after each file it recomputes the forward of
``tests/test_torch_fused_qformer_vjp.py::test_self_block_matches_jax
[full_tiles]`` (the port's B12s plain version against the JAX kernel in
interpret mode, both in this process) as a share of that test's tolerance
(rtol 1e-5, atol 1e-6), and records which process-wide settings changed
since the previous file: torch threads, matmul precision, default dtype,
grad, autocast and determinism modes, the FP rounding mode, denormal
flushing in numpy and torch, every JAX config value and the environment.

Run it beside the suite, as the tier-1 command runs it:

    PYTHONPATH=scripts JAX_PLATFORMS=cpu python -m pytest tests/ -q \\
        -m 'not slow' -p xdist -n 6 --dist loadfile -p no:randomly \\
        -p probe_test_state

One JSON line per file and worker goes to
``build/test_state_probe/<worker>.jsonl`` (``TEST_STATE_PROBE_DIR``
overrides): ``share`` is the largest |port - JAX| over its tolerance,
``changed`` / ``jax_changed`` / ``env_changed`` the settings that moved.
"""

import ctypes
import json
import os
import time
from pathlib import Path

import pytest

_OUT = Path(os.environ.get("TEST_STATE_PROBE_DIR",
                           Path(__file__).resolve().parents[1]
                           / "build" / "test_state_probe"))
_SEEN = {}


def _state() -> dict:
    import jax
    import numpy as np
    import torch

    libm = ctypes.CDLL("libm.so.6")
    st = dict(
        threads=torch.get_num_threads(),
        interop=torch.get_num_interop_threads(),
        matmul=torch.get_float32_matmul_precision(),
        dtype=str(torch.get_default_dtype()),
        grad=torch.is_grad_enabled(),
        deterministic=torch.are_deterministic_algorithms_enabled(),
        autocast_cpu=torch.is_autocast_cpu_enabled(),
        mkldnn=torch.backends.mkldnn.enabled,
        rounding=libm.fegetround(),
        numpy_denormal=float(np.float32(1e-39) * np.float32(1)),
        torch_denormal=float(torch.tensor([1e-39]) * 1.0),
        jax={k: str(v) for k, v in jax.config.values.items()},
        env={k: v for k, v in os.environ.items()
             if k != "PYTEST_CURRENT_TEST"},
    )
    return st


def _share() -> float:
    import jax.numpy as jnp
    import numpy as np
    import torch

    from unirec_tpu.ops import fused_qformer_vjp as jvjp
    from unirec_tpu_torch.ops import fused_qformer_vjp as pvjp

    heads, d, b, k = 4, 128, 8, 32  # the full_tiles case and its inputs
    rng = np.random.RandomState(0)
    w = dict(
        wq=rng.randn(d, d) * 0.05, bq=rng.randn(d) * 0.01,
        wkv=rng.randn(d, 2 * d) * 0.05, bkv=rng.randn(2 * d) * 0.01,
        wqkv=rng.randn(d, 3 * d) * 0.05, bqkv=rng.randn(3 * d) * 0.01,
        wo=rng.randn(d, d) * 0.05, bo=rng.randn(d) * 0.01)
    x = rng.randn(b, k, d).astype(np.float32)
    kbias = np.zeros((b, k), np.float32)
    arrays = [x, w["wqkv"], w["bqkv"], w["wo"], w["bo"]]
    transpose = [False, True, False, True, False]
    want = np.asarray(jvjp.fused_self_attention_train(
        jnp.asarray(x), jnp.asarray(kbias),
        *[jnp.asarray(a, jnp.float32) for a in arrays[1:]],
        num_heads=heads, interpret=True))
    t = [torch.tensor(a.T if f else a, dtype=torch.float32)
         for a, f in zip(arrays, transpose)]
    got = pvjp.fused_self_attention_train(
        t[0], torch.tensor(kbias), *t[1:], num_heads=heads).detach().numpy()
    return float((np.abs(got - want) / (1e-6 + 1e-5 * np.abs(want))).max())


def _record(item, where: str) -> None:
    worker = os.environ.get("PYTEST_XDIST_WORKER", "main")
    t0 = time.time()
    rec = dict(file=Path(str(item.fspath)).name, where=where)
    try:
        rec["share"] = _share()
    except Exception as e:  # the record says why
        rec["error"] = repr(e)
    st = _state()
    prev = _SEEN.get(worker)
    if prev is not None:
        rec["changed"] = {n: (prev[n], v) for n, v in st.items()
                          if n not in ("jax", "env") and prev[n] != v}
        rec["jax_changed"] = {n: (prev["jax"].get(n), v)
                              for n, v in st["jax"].items()
                              if prev["jax"].get(n) != v}
        rec["env_changed"] = sorted(set(prev["env"].items())
                                    ^ set(st["env"].items()))
    _SEEN[worker] = st
    rec["seconds"] = round(time.time() - t0, 2)
    _OUT.mkdir(parents=True, exist_ok=True)
    with open(_OUT / f"{worker}.jsonl", "a") as f:
        f.write(json.dumps(rec) + "\n")


def pytest_runtest_setup(item):
    if os.environ.get("PYTEST_XDIST_WORKER", "main") not in _SEEN:
        _record(item, "first")


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_teardown(item, nextitem):
    yield  # after the file's fixtures are finalized
    if nextitem is None or nextitem.fspath != item.fspath:
        _record(item, "after")
