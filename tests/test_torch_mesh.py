"""The port's mesh layer (``unirec_tpu_torch/parallel/mesh.py``) against
``unirec_tpu/parallel/mesh.py``, its torch.distributed world, and the
training CLI's ranks, on the CPU.

* ``make_mesh``'s device order equals the JAX mesh's for (dp, tp, sp) =
  (2, 1, 2), (4, 1, 1) and (-1, 1, 2) over the 8 virtual devices;
  ``MeshConfig.axis_sizes``' errors; ``pad_batch`` equals JAX's; a mesh
  larger than the devices raises "needs N devices";
* two gloo ranks (``tests/torch_dist_ranks.py``) join through
  ``init_distributed`` from torchrun's environment (the counterpart of
  ``tests/test_multihost.py``): the dp / sp groups, the bucketed all-reduce,
  the broadcast of rank 0's module and rank 0 first;
* ``train item-qformer --dp 2`` and ``train joint --dp 2`` spawn two gloo
  ranks each (``python -m unirec_tpu_torch``), then ``--resume``; rank 0
  alone prints and logs; a rank that fails fails the command;
  ``train user-qformer --sp 2`` runs as two torchrun ranks; more ranks than
  cards (``--pp`` ranks too) and ``--tp`` with flash / fused training are
  refused before anything spawns (``--tp`` and ``--pp`` themselves:
  ``tests/test_torch_tp.py``, ``tests/test_torch_pipeline.py``).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests import torch_dist_ranks as ranks
from tests.torch_dist_ranks import one_torch_thread  # noqa: F401
from unirec_tpu.configs import MeshConfig as JaxMeshConfig
from unirec_tpu.parallel.mesh import make_mesh as jax_make_mesh
from unirec_tpu.parallel.mesh import pad_batch as jax_pad_batch
from unirec_tpu_torch.configs import MeshConfig
from unirec_tpu_torch.parallel.mesh import make_mesh, pad_batch


CLI_TIMEOUT_S = 240.0


@pytest.mark.parametrize("dp,tp,sp", [(2, 1, 2), (4, 1, 1), (-1, 1, 2)])
def test_rank_layout_is_jax_device_order(eight_devices, dp, tp, sp):
    want = jax_make_mesh(JaxMeshConfig(dp=dp, tp=tp, sp=sp), eight_devices)
    got = make_mesh(MeshConfig(dp=dp, tp=tp, sp=sp), list(range(8)))
    assert got.shape == dict(want.shape)
    ids = np.vectorize(lambda d: d.id)(want.devices)
    np.testing.assert_array_equal(got.devices.astype(np.int64), ids)
    assert got.dp_devices == list(ids[:, 0, 0])


def test_axis_sizes_errors_and_too_many_devices():
    for dp, tp, sp in ((3, 1, 1), (-1, 3, 1), (2, 2, 3)):
        with pytest.raises(ValueError) as jax_err:
            JaxMeshConfig(dp=dp, tp=tp, sp=sp).axis_sizes(8)
        with pytest.raises(ValueError) as err:
            MeshConfig(dp=dp, tp=tp, sp=sp).axis_sizes(8)
        assert str(err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        make_mesh(MeshConfig(dp=4, sp=4), list(range(8)))
    # one device named twice: replicas that share it
    assert make_mesh(MeshConfig(dp=2), ["cpu", "cpu"]).dp_devices == [
        "cpu", "cpu"]


@pytest.mark.parametrize("n,multiple", [(5, 2), (6, 3), (7, 4), (1, 8)])
def test_pad_batch_equals_jax(n, multiple):
    rng = np.random.default_rng(n)
    batch = {"a": rng.standard_normal((n, 3)).astype(np.float32),
             "b": np.arange(n, dtype=np.int32)}
    got, got_n = pad_batch(batch, multiple)
    want, want_n = jax_pad_batch(batch, multiple)
    assert got_n == want_n == n
    for k in batch:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].shape[0] % multiple == 0


# -- ranks and the CLI ---------------------------------------------------------------


def _user_cli_inputs(tmp):
    """Files of ``train user-qformer`` (a tiny Item Q-Former checkpoint, its
    cache, histories, reviews) and the widths it shrinks
    ``UserQFormerConfig()`` to."""
    from unirec_tpu_torch import configs as pc
    from unirec_tpu_torch.data.cache import FieldEmbeddingCache
    from unirec_tpu_torch.utils.checkpoint import save_checkpoint
    from unirec_tpu_torch.utils.weights import init_item_qformer

    d, k, n = 32, 4, 30
    iq = pc.ItemQFormerConfig(hidden_size=d, num_hidden_layers=1,
                              num_attention_heads=2, intermediate_size=64,
                              num_query_tokens=k, field_embedding_dim=d,
                              num_fields=3)
    save_checkpoint(os.path.join(tmp, "iq"),
                    init_item_qformer(iq, torch.Generator().manual_seed(0)),
                    config=iq, extra={"field_names": ["a", "b", "c"]})
    rng = np.random.RandomState(5)
    ids = [f"i{j}" for j in range(n)]
    FieldEmbeddingCache(rng.randn(n, 3, d).astype(np.float32),
                        np.ones((n, 3), np.float32), ["a", "b", "c"],
                        ids).save(os.path.join(tmp, "cache"))
    hist = [{"history": [ids[j] for j in rng.choice(n, m)]}
            for m in (8, 12, 5, 9)]
    with open(os.path.join(tmp, "hist.json"), "w") as f:
        json.dump(hist, f)
    with open(os.path.join(tmp, "rev.json"), "w") as f:
        json.dump({f"u{j % 3}|{i}": {"unixReviewTime": int(1.4e9) + 7 * j}
                   for j, i in enumerate(ids)}, f)
    argv = ["user-qformer", "--item-qformer-checkpoint",
            os.path.join(tmp, "iq"), "--history", os.path.join(tmp,
                                                               "hist.json"),
            "--reviews", os.path.join(tmp, "rev.json"), "--cache-dir",
            os.path.join(tmp, "cache"), "--device", "cpu", "--batch-size",
            "8", "--max-seq-len", "12", "--num-epochs", "1",
            "--checkpoint-dir", os.path.join(tmp, "user_ck")]
    widths = dict(hidden_size=d, num_hidden_layers=1, num_attention_heads=2,
                  intermediate_size=64, num_query_tokens=8)
    return {"user_cli_argv": argv, "user_cli_widths": widths}


def _sp2(inputs):
    return dict(inputs, user_cli_argv=inputs["user_cli_argv"] + ["--sp", "2"])


def _cli(tmp, name, argv):
    """``python -m unirec_tpu_torch train ARGV`` in the background."""
    out = open(os.path.join(tmp, f"{name}.log"), "w")
    return subprocess.Popen(
        [sys.executable, "-m", "unirec_tpu_torch", "train"] + argv,
        cwd=ranks.REPO, env=ranks.child_env(), stdout=out,
        stderr=subprocess.STDOUT, start_new_session=True)


def _log(tmp, name):
    with open(os.path.join(tmp, f"{name}.log")) as f:
        return f.read()


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Every rank program of the module, started at once: the init world,
    the torchrun-style user-qformer world, and the CLI commands."""
    from pathlib import Path

    from tests.test_torch_train_item import _cli_files as item_files
    from tests.test_torch_train_joint import _cli_files as joint_files
    from unirec_tpu_torch.utils.checkpoint import read_meta

    tmp = str(tmp_path_factory.mktemp("mesh"))
    torch.save(_sp2(_user_cli_inputs(tmp)),
               os.path.join(tmp, "user_cli.inputs.pt"))
    groups = {case: ranks.start_group(case, 2, tmp)
              for case in ("init", "user_cli")}
    for name in ("item", "joint"):
        os.makedirs(os.path.join(tmp, name))
    item = item_files(Path(tmp) / "item")
    joint = joint_files(Path(tmp) / "joint")
    bad = list(item)
    bad[bad.index("--sequences") + 1] = os.path.join(tmp, "missing.json")
    cli = {"item": _cli(tmp, "item", ["item-qformer"] + item + ["--dp", "2"]),
           "joint": _cli(tmp, "joint", joint + ["--flash-vjp", "--no-remat",
                                                "--dp", "2"]),
           "bad": _cli(tmp, "bad", ["item-qformer"] + bad + ["--dp", "2"])}
    done = {}
    for name in ("item", "joint"):
        ranks.finish([cli[name]], [os.path.join(tmp, f"{name}.log")],
                     CLI_TIMEOUT_S)
        done[name] = _log(tmp, name)
    done["item_step"] = read_meta(os.path.join(tmp, "item", "ck"))["step"]
    resume = _cli(tmp, "item_resume", ["item-qformer"] + item + [
        "--dp", "2", "--resume", "--num-epochs", "1"])
    try:  # the command fails: finish raises with its output
        ranks.finish([cli["bad"]], [os.path.join(tmp, "bad.log")],
                     CLI_TIMEOUT_S)
    except AssertionError:
        pass
    done["bad"] = (cli["bad"].returncode, _log(tmp, "bad"))
    ranks.finish([resume], [os.path.join(tmp, "item_resume.log")],
                 CLI_TIMEOUT_S)
    done["item_resume"] = _log(tmp, "item_resume")
    results = {case: ranks.finish_group(case, procs, tmp)
               for case, procs in groups.items()}
    return tmp, done, results


def test_init_distributed_groups_and_collectives(launched):
    _, _, results = launched
    got = results["init"]
    for rank, r in enumerate(got):
        assert r["world"] == 2 and r["backend"] == "gloo"
        assert r["writer"] == (rank == 0)
        assert r[(1, 2)] == (0, rank, 1, 2, 1, 2)   # sp over both ranks
        assert r[(-1, 1)] == (rank, 0, 2, 1, 2, 1)  # dp over both ranks
        assert "needs 4 devices, have 2" in r["too_big"]
        a, b, c = r["reduced"]
        torch.testing.assert_close(a, torch.full((3,), 1.5))
        torch.testing.assert_close(b, torch.arange(5, dtype=torch.float64)
                                   * 1.5)
        torch.testing.assert_close(c, torch.full((2, 2), 0.5))
        assert torch.equal(r["broadcast"], torch.full((2, 3), 7.0))
        assert r["read"] == "rank 0"


def test_train_item_qformer_dp2_spawns_and_resumes(launched):
    from unirec_tpu_torch.utils.checkpoint import read_meta

    tmp, done, _ = launched
    out = done["item"]
    assert '"val_recon_loss"' in out
    ck = os.path.join(tmp, "item", "ck")
    steps = done["item_step"]
    assert steps > 0
    with open(os.path.join(ck, "metrics.jsonl")) as f:
        # rank 0 alone logs: 2 + 1 (resumed) epochs x (train, validation)
        assert len(f.readlines()) == 6
    assert f"resumed from {ck} at step {steps}" in done["item_resume"]
    assert done["item_resume"].count("resumed from") == 1  # rank 0 prints
    assert read_meta(ck)["step"] > steps


def test_train_joint_dp2_spawns(launched):
    from unirec_tpu_torch.utils.checkpoint import read_meta

    tmp, done, _ = launched
    out = done["joint"]
    assert out.count("initial eval:") == 1 and out.count("final eval:") == 1
    meta = read_meta(os.path.join(tmp, "joint", "ck", "latest_model"))
    # 12 samples at batch 4 (2 rows a rank): evaluated and saved at step 2
    assert meta["step"] == 2 and meta["qwen_config"]["flash_vjp_attention"]


def test_a_failing_rank_fails_the_command(launched):
    _, done, _ = launched
    rc, out = done["bad"]
    assert rc != 0 and "missing.json" in out


def test_train_user_qformer_sp2_as_torchrun_ranks(launched):
    from unirec_tpu_torch.utils.checkpoint import read_meta

    tmp, _, results = launched
    assert [r["rc"] for r in results["user_cli"]] == [0, 0]
    meta = read_meta(os.path.join(tmp, "user_ck"))
    assert meta["config"]["sequence_parallel"] and meta["step"] > 0


@pytest.mark.parametrize("extra,error,match", [
    (["--dp", "2", "--device", "cuda"], ValueError, "needs 2 cards, have"),
    # --tp is ported (tests/test_torch_tp.py); with --flash it is refused,
    # as in the JAX package
    (["--tp", "2", "--flash"], ValueError, "incompatible with tp>1"),
    (["--sp", "2", "--flash"], ValueError, "incompatible with flash")],
    ids=["more-ranks-than-cards", "tp", "sp-with-flash"])
def test_refusals_before_anything_spawns(tmp_path, monkeypatch, extra, error,
                                         match):
    from unirec_tpu_torch.cli import train_cli

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    argv = _user_cli_inputs(str(tmp_path))["user_cli_argv"]
    with pytest.raises(error, match=match):
        train_cli.main(argv + extra)
    joint_pp = ["joint", "--train-data", "t", "--val-data", "v", "--item-emb",
                "e", "--item-dict", "d", "--qformer-checkpoint", "q",
                "--cache-dir", "c", "--pp", "2"]
    # --pp is ported (tests/test_torch_pipeline.py): its two ranks need two
    # cards
    with pytest.raises(ValueError, match="needs 2 cards, have 1"):
        train_cli.main(joint_pp)
