"""The port imports torch and never JAX, Flax, the JAX package
``unirec_tpu`` or the JAX scripts of ``scripts/`` (not even their
framework-free parts: the port carries its own copies), and builds nothing
at import time; every module imports where ``transformers``,
``tokenizers``, ``peft``, PIL and ``requests`` are absent (the card's
machine has none of them); its kernel wrappers take the plain versions for
CPU tensors and leave their launch counters at 0.  The entry points run on
the card unless asked for the CPU."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tests.torch_dist_ranks import one_torch_thread  # noqa: F401


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
# the Hugging Face and image packages are imported where they are used only
for name in ("transformers", "tokenizers", "PIL", "requests", "peft"):
    sys.modules[name] = None
import unirec_tpu_torch
names = ["unirec_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(unirec_tpu_torch.__path__,
                                          "unirec_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "triton",
                                    "unirec_tpu", "scripts"))
import json
print(json.dumps({"modules": names, "framework": bad}))
"""

# the modules of each slice, which the walk must reach (the item-training
# slice's among them)
EXPECTED_MODULES = {
    "unirec_tpu_torch.ops.fused_qformer_vjp", "unirec_tpu_torch.models.mwne",
    "unirec_tpu_torch.encoders.backends",
    "unirec_tpu_torch.encoders.item_encoder",
    "unirec_tpu_torch.eval.reconstruction",
    "unirec_tpu_torch.train.item_qformer", "unirec_tpu_torch.cli.train_cli",
    "unirec_tpu_torch.ops.fused_qformer_layer",
    "unirec_tpu_torch.ops.flash_causal", "unirec_tpu_torch.train.joint",
    "unirec_tpu_torch.ops.flash_vjp", "unirec_tpu_torch.models.user_sequence",
    "unirec_tpu_torch.models.user_qformer",
    "unirec_tpu_torch.train.user_qformer", "unirec_tpu_torch.eval.user_eval",
    "unirec_tpu_torch.ops.packed_attention",
    # the pipeline's front end
    "unirec_tpu_torch.__main__", "unirec_tpu_torch.data.builders",
    "unirec_tpu_torch.cli.data_pipeline", "unirec_tpu_torch.models.clip",
    "unirec_tpu_torch.cli.candidate_embeddings",
    "unirec_tpu_torch.cli.review_embeddings",
    "unirec_tpu_torch.cli.user_embeddings",
    # A8: the Q-Former's text branch and LM heads, decoding, MWNE training,
    # the exporters and the debugging aids
    "unirec_tpu_torch.models.qformer", "unirec_tpu_torch.models.qformer_decode",
    "unirec_tpu_torch.train.mwne", "unirec_tpu_torch.utils.torch_convert",
    "unirec_tpu_torch.utils.debug", "unirec_tpu_torch.utils.profiling",
    # A9's data and sequence parallelism
    "unirec_tpu_torch.parallel", "unirec_tpu_torch.parallel.mesh",
    "unirec_tpu_torch.ops.sharded_attention",
    # A9's tensor and pipeline parallelism
    "unirec_tpu_torch.parallel.tensor", "unirec_tpu_torch.parallel.pipeline",
    # the quality gates and the convergence demo
    "unirec_tpu_torch.scripts", "unirec_tpu_torch.scripts.convergence_demo",
    "unirec_tpu_torch.scripts.int8_base_convergence",
    "unirec_tpu_torch.scripts.measure_int8_quality",
    "unirec_tpu_torch.scripts.measure_serving_quality",
    "unirec_tpu_torch.scripts.quality_gates",
}


def test_fresh_import_loads_no_jax_or_flax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(result["modules"]) >= 15  # every module of the package
    assert EXPECTED_MODULES <= set(result["modules"])
    assert result["framework"] == []


def test_chip_smoke_imports_nothing_of_the_jax_package():
    """chip_smoke.py, at any depth of its functions, imports no module of
    jax, flax or unirec_tpu."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "unirec_tpu_torch.ops._build" in names  # the walk sees imports
    bad = [n for n in names
           if n.split(".")[0] in ("jax", "jaxlib", "flax", "unirec_tpu")]
    assert bad == []


@pytest.mark.parametrize("entry", ["qformer_inference", "serve_cli",
                                   "generate_all_item_embeddings",
                                   "train_cli", "train_cli_item_qformer",
                                   "train_cli_user_qformer", "user_embeddings",
                                   "text_backend", "image_backend",
                                   "measure_int8_quality",
                                   "measure_serving_quality",
                                   "convergence_demo",
                                   "int8_base_convergence"])
def test_entry_points_default_to_the_card(entry, monkeypatch, tmp_path):
    """Without a card, an entry point that was not asked for the CPU raises
    and names the flag; nothing falls back to the CPU quietly."""
    from unirec_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="--device cpu"):
        if entry == "qformer_inference":
            from unirec_tpu_torch.configs import ItemQFormerConfig
            from unirec_tpu_torch.inference.qformer_inference import (
                QFormerInference,
            )

            QFormerInference(config=ItemQFormerConfig(), params={},
                             field_names=[])
        elif entry == "serve_cli":
            from unirec_tpu_torch.cli import serve_cli

            serve_cli.build_recommender(serve_cli.parse_args(
                ["--qformer-checkpoint", "q", "--cache-dir", "c",
                 "--item-dict", "i", "--catalog", "e"]))
        elif entry == "generate_all_item_embeddings":
            from unirec_tpu_torch.cli import generate_all_item_embeddings

            generate_all_item_embeddings.main(
                ["--checkpoint", "q", "--cache-dir", REPO])
        elif entry == "user_embeddings":
            from unirec_tpu_torch.cli import user_embeddings

            (tmp_path / "h.json").write_text(json.dumps({"u": ["a"]}))
            user_embeddings.main(
                ["--qformer-checkpoint", "q", "--cache-dir", "c",
                 "--item-dict", "i", "--catalog", "e", "--histories",
                 str(tmp_path / "h.json"), "--output", "o"])
        elif entry in ("measure_int8_quality", "measure_serving_quality",
                       "convergence_demo", "int8_base_convergence"):
            import importlib

            importlib.import_module(
                f"unirec_tpu_torch.scripts.{entry}").main([])
        elif entry == "text_backend":
            from unirec_tpu_torch.encoders.backends import Qwen3TextBackend

            Qwen3TextBackend()
        elif entry == "image_backend":
            from unirec_tpu_torch.encoders.backends import CLIPImageBackend

            CLIPImageBackend()
        elif entry == "train_cli_user_qformer":
            from unirec_tpu_torch.cli import train_cli

            train_cli.main(["user-qformer", "--item-qformer-checkpoint", "q",
                            "--history", "h", "--reviews", "r",
                            "--cache-dir", "c", "--bf16", "--flash",
                            "--fused"])
        elif entry == "train_cli_item_qformer":
            from unirec_tpu_torch.cli import train_cli

            train_cli.main(["item-qformer", "--data", "d", "--sequences", "s",
                            "--cache-dir", "c", "--bf16", "--fused-anchor"])
        else:
            from unirec_tpu_torch.cli import train_cli

            train_cli.main(["joint", "--train-data", "t", "--val-data", "v",
                            "--item-emb", "e", "--item-dict", "i",
                            "--qformer-checkpoint", "q", "--cache-dir", "c"])


def test_cpu_wrappers_use_plain_versions():
    from unirec_tpu_torch.ops import _build
    from unirec_tpu_torch.ops import fused_qformer_layer as fq
    from unirec_tpu_torch.ops.flash_causal import flash_causal_attention
    from unirec_tpu_torch.ops.ranking import retrieve_top_k

    blocks = (fq.fused_self_attention_block, fq.fused_cross_attention_block,
              fq.fused_ffn_block)
    for fn in (flash_causal_attention, retrieve_top_k) + blocks:
        fn.launches = 0
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 8, 2 * 128, generator=gen)
    kv = torch.randn(1, 8, 128, generator=gen)
    out = flash_causal_attention(q, kv, kv, torch.ones(1, 8), 2, 1)
    s, i = retrieve_top_k(torch.randn(3, 16, generator=gen),
                          torch.randn(50, 16, generator=gen), k=5)
    assert out.shape == q.shape and s.shape == i.shape == (3, 5)
    # B1-B3 in bfloat16, the dtype their kernels take on the card
    d, k, f, dm, inter = 16, 4, 3, 8, 32

    def w(*shape):
        return torch.randn(*shape, generator=gen).bfloat16()

    def v(n):
        return torch.randn(n, generator=gen)

    x = w(2, k, d)
    y1 = fq.fused_self_attention_block(x, w(3 * d, d), v(3 * d), w(d, d), v(d),
                                       v(d), v(d), num_heads=2, n_q=k)
    y2 = fq.fused_cross_attention_block(
        x, w(2, f, dm), torch.zeros(2, f), w(d, d), v(d), w(2 * d, dm),
        v(2 * d), w(d, d), v(d), v(d), v(d), num_heads=2, n_q=k, n_kv=f)
    y3 = fq.fused_ffn_block(x, w(inter, d), v(inter), w(d, inter), v(d), v(d),
                            v(d))
    assert all(y.shape == x.shape and y.dtype == torch.bfloat16
               for y in (y1, y2, y3))
    for fn in (flash_causal_attention, retrieve_top_k) + blocks:
        assert fn.launches == 0, fn.__name__
    # nothing was compiled or loaded for CPU tensors
    assert _build.load_kernels.cache_info().currsize == 0


def test_cpu_int8_wrappers_use_plain_versions():
    from unirec_tpu_torch.ops import _build
    from unirec_tpu_torch.ops import fused_qformer_int8 as pq
    from unirec_tpu_torch.ops.quantization import (
        quantize_rows,
        retrieve_top_k_int8,
    )

    wrappers = (pq.fused_self_attention_block_q,
                pq.fused_cross_attention_block_q, pq.fused_ffn_block_q,
                retrieve_top_k_int8)
    for fn in wrappers:
        fn.launches = 0
    gen = torch.Generator().manual_seed(0)
    d, k, f, dm, inter = 16, 4, 3, 16, 128

    def q(*shape):  # (int8 weight [out, in], float32 scales [out])
        return pq.quantize_weight(torch.randn(*shape, generator=gen))

    def v(n):
        return torch.randn(n, generator=gen)

    x = torch.randn(2, k, d, generator=gen).bfloat16()
    y1 = pq.fused_self_attention_block_q(x, *q(3 * d, d), v(3 * d), *q(d, d),
                                         v(d), v(d), v(d), num_heads=2, n_q=k)
    y2 = pq.fused_cross_attention_block_q(
        x, torch.randn(2, f, dm, generator=gen).bfloat16(), torch.zeros(2, f),
        *q(d, d), v(d), *q(2 * d, dm), v(2 * d), *q(d, d), v(d), v(d), v(d),
        num_heads=2, n_q=k, n_kv=f)
    y3 = pq.fused_ffn_block_q(x, *q(inter, d), v(inter), *q(d, inter), v(d),
                              v(d), v(d))
    assert all(y.shape == x.shape and y.dtype == torch.bfloat16
               for y in (y1, y2, y3))
    codes, scales = quantize_rows(torch.randn(50, 16, generator=gen))
    s, i = retrieve_top_k_int8(torch.randn(3, 16, generator=gen), codes,
                               scales, k=5)
    assert s.shape == i.shape == (3, 5)
    for fn in wrappers:
        assert fn.launches == 0, fn.__name__
    assert _build.load_kernels.cache_info().currsize == 0


def test_cpu_qwen3_int8_wrappers_use_plain_versions():
    from unirec_tpu_torch.ops import _build
    from unirec_tpu_torch.ops import fused_qwen3_int8 as pf
    from unirec_tpu_torch.ops.fused_qformer_int8 import quantize_weight
    from unirec_tpu_torch.ops.int8_matmul import int8_linear
    from unirec_tpu_torch.ops.int8_ste import int8_linear_ste

    wrappers = (int8_linear, pf.qkv_int8, pf.swiglu_mlp_int8)
    for fn in wrappers:
        fn.launches = 0
    gen = torch.Generator().manual_seed(0)
    d, inter, rows = 128, 256, 512

    def q(*shape):  # (int8 weight [out, in], float32 scales [out])
        return quantize_weight(torch.randn(*shape, generator=gen))

    x = torch.randn(rows, d, generator=gen).bfloat16()
    y8 = int8_linear(x, *q(64, d))
    ys = int8_linear_ste(x[None], *q(64, d))
    yq = pf.qkv_int8(x, *q(3 * d, d))
    ym = pf.swiglu_mlp_int8(x, *q(2 * inter, d), *q(d, inter))
    yf = pf.int8_linear_fused_ste(x, *q(3 * d, d))
    assert y8.shape == (rows, 64) and ys.shape == (1, rows, 64)
    assert yq.shape == yf.shape == (rows, 3 * d) and ym.shape == x.shape
    assert all(y.dtype == torch.bfloat16 for y in (y8, ys, yq, ym, yf))
    for fn in wrappers:
        assert fn.launches == 0, fn.__name__
    assert _build.load_kernels.cache_info().currsize == 0


def test_cpu_b12_wrappers_use_plain_versions():
    """B12s / B12c forward and backward, and their autograd blocks, take the
    plain versions for CPU tensors in bfloat16 (the kernels' dtype): nothing
    is launched, counted or built."""
    from unirec_tpu_torch.ops import _build
    from unirec_tpu_torch.ops import fused_qformer_vjp as fv

    wrappers = (fv.self_attention_fwd, fv.self_attention_bwd,
                fv.cross_attention_fwd, fv.cross_attention_bwd)
    for fn in wrappers:
        fn.launches = 0
    gen = torch.Generator().manual_seed(0)
    b, k, f, d = 2, 4, 3, 16

    def w(*shape):
        return (torch.randn(*shape, generator=gen) * 0.1).bfloat16(
            ).requires_grad_()

    x, mem = w(b, k, d), w(b, f, d)
    bias = torch.zeros(b, f)
    bias[0] = -1e9  # an item with no valid field
    y = fv.fused_self_attention_train(x, torch.zeros(b, k), w(3 * d, d),
                                      w(3 * d), w(d, d), w(d), num_heads=2)
    z = fv.fused_cross_attention_train(y, mem, bias, w(d, d), w(d),
                                       w(2 * d, d), w(2 * d), w(d, d), w(d),
                                       num_heads=2)
    z.float().square().sum().backward()
    assert z.shape == x.shape and z.dtype == torch.bfloat16
    assert x.grad is not None and mem.grad is not None
    assert bool(torch.isfinite(x.grad.float()).all())
    for fn in wrappers:
        assert fn.launches == 0, fn.__name__
    assert _build.load_kernels.cache_info().currsize == 0


def test_cpu_flash_cross_wrappers_use_plain_versions():
    """B13, B14's forward and backward, and the trainable proj-VJP take the
    plain versions for CPU tensors in bfloat16 (a kernel dtype): nothing is
    launched, counted or built."""
    from unirec_tpu_torch.ops import _build
    from unirec_tpu_torch.ops import attention as pa
    from unirec_tpu_torch.ops import flash_vjp as fl

    wrappers = (pa.flash_cross_attention, fl.flash_cross_fwd,
                fl.flash_cross_bwd)
    for fn in wrappers:
        fn.launches = 0
    gen = torch.Generator().manual_seed(0)
    b, lq, lkv, d = 2, 4, 70, 32

    def w(*shape):
        return (torch.randn(*shape, generator=gen) * 0.1).bfloat16(
            ).requires_grad_()

    bias = torch.zeros(b, 1, 1, lkv)
    bias[1] = -1e9  # a user with no cached history
    q, mem = w(b, lq, d), w(b, lkv, d)
    with torch.no_grad():
        o = pa.flash_cross_attention(pa.split_heads(q, 2), pa.split_heads(
            mem, 2), pa.split_heads(mem, 2), bias)
    z = fl.flash_cross_attention_proj_vjp(q, mem, w(d, d), w(d), w(d, d),
                                          w(d), bias, num_heads=2)
    z.float().square().sum().backward()
    assert o.shape == (b, 2, lq, d // 2) and o.dtype == torch.bfloat16
    assert z.shape == q.shape and z.dtype == torch.bfloat16
    assert bool(torch.isfinite(mem.grad.float()).all())
    for fn in wrappers:
        assert fn.launches == 0, fn.__name__
    assert _build.load_kernels.cache_info().currsize == 0


def test_build_dir_follows_the_environment(monkeypatch, tmp_path):
    """The kernel library goes to ``UNIREC_TPU_TORCH_BUILD_DIR`` when it is
    set, else to build/unirec_tpu_torch at the repository root; resolving
    the directory creates and compiles nothing."""
    from unirec_tpu_torch.ops import _build

    monkeypatch.delenv(_build.BUILD_DIR_ENV, raising=False)
    assert _build.build_dir() == Path(REPO).resolve() / "build" / \
        "unirec_tpu_torch"
    target = tmp_path / "kernels"
    monkeypatch.setenv(_build.BUILD_DIR_ENV, str(target))
    assert _build.build_dir() == target.resolve()
    assert not target.exists()
    assert _build.load_kernels.cache_info().currsize == 0


def test_hugging_face_loaders_read_local_files_only(monkeypatch):
    """Every ``from_pretrained`` of the port reads a local directory and
    never asks the hub (``--hf-path``, ``--tokenizer`` and the encoders'
    paths are local checkpoints): each call passes ``local_files_only=True``,
    and a name that is no directory fails at once."""
    calls = []
    for path in Path(REPO, "unirec_tpu_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "from_pretrained"):
                kw = {k.arg: k.value for k in node.keywords}
                calls.append((path.name, node.lineno))
                flag = kw.get("local_files_only")
                assert isinstance(flag, ast.Constant) and flag.value is True, \
                    calls[-1]
    assert len(calls) >= 8
    import types

    seen = {}

    class Auto:
        @staticmethod
        def from_pretrained(name, **kw):
            seen.update(kw, name=name)
            raise OSError(f"{name} is not a local directory")

    monkeypatch.setitem(sys.modules, "transformers",
                        types.SimpleNamespace(AutoTokenizer=Auto))
    from unirec_tpu_torch.data.tokenizer import make_tokenizer

    with pytest.raises(ValueError, match="somewhere"):
        make_tokenizer("somewhere")
    assert seen == {"name": "somewhere", "local_files_only": True}
