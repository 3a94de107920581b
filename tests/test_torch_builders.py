"""Port parity: the data pipeline, unirec_tpu_torch vs unirec_tpu.

Every builder of ``data/builders.py`` on seeded fixtures gives the JAX
package's values (the samplers draw from ``random.Random(seed)`` in the same
order), and every ``data`` subcommand writes the same files byte for byte.
"""

import json
import random

import pytest

from unirec_tpu.cli import data_pipeline as jax_cli
from unirec_tpu.data import builders as jax_builders
from unirec_tpu_torch.cli import data_pipeline as port_cli
from unirec_tpu_torch.data import builders

N_ITEMS, N_USERS = 60, 40


def write_raw(root, n_items=N_ITEMS, n_users=N_USERS, seed=0) -> None:
    """meta.jsonl, reviews.jsonl and x.inter of All_Beauty's shape."""
    rng = random.Random(seed)
    with open(root / "meta.jsonl", "w") as f:
        for i in range(n_items):
            item = {"parent_asin": f"A{i}", "title": f"Product {i}",
                    "main_category": "All Beauty", "store": f"S{i % 7}",
                    "price": None if i % 9 == 0 else 3.5 + i,
                    "average_rating": round(rng.uniform(1, 5), 1),
                    "rating_number": rng.randint(0, 500),
                    "description": [f"desc {i}", "extra"] if i % 4 else [],
                    "features": [f"feat {i}"] if i % 3 else [],
                    "details": {"Brand": f"B{i % 5}", "Color": "red",
                                "Weight": "2 oz"},
                    "images": [{"variant": "PT01", "large": f"http://x/{i}b"},
                               {"variant": "MAIN", "hi_res": f"http://x/{i}h",
                                "large": None if i % 5 == 0
                                else f"http://x/{i}.jpg"}]}
            f.write(json.dumps(item) + "\n")
        f.write("\n")  # a blank line is skipped
        f.write(json.dumps({"title": "no asin"}) + "\n")
    with open(root / "reviews.jsonl", "w") as f:
        for u in range(n_users):
            for t in range(3):
                f.write(json.dumps({
                    "user_id": f"u{u}", "parent_asin": f"A{(u * 7 + t) % n_items}",
                    "title": "nice", "text": f"review {u}-{t}", "rating": 5.0,
                    "images": [{"large_image_url": f"http://r/{u}{t}.jpg"}]
                    if (u + t) % 4 == 0 else [],
                    "timestamp": 1000 + t}) + "\n")
    with open(root / "x.inter", "w") as f:
        f.write("user_id:token\titem_id:token\trating:float\ttimestamp:float\n")
        for u in range(n_users):
            for t in range(8 + (u * 5) % 17):
                f.write(f"u{u}\tA{(u * 11 + 3 * t) % n_items}\t"
                        f"{rng.randint(1, 5)}.0\t{1000 + rng.randint(0, 10**6)}\n")
        f.write("short\tline\n")


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    root = tmp_path_factory.mktemp("raw")
    write_raw(root)
    return root


def test_dict_and_triplet_builders_match_jax(raw):
    items = builders.build_item_dict(str(raw / "meta.jsonl"))
    assert items == jax_builders.build_item_dict(str(raw / "meta.jsonl"))
    assert len(items) == N_ITEMS
    reviews = builders.build_review_dict(str(raw / "reviews.jsonl"))
    assert reviews == jax_builders.build_review_dict(str(raw / "reviews.jsonl"))
    from unirec_tpu_torch.configs import DEFAULT_FIELD_MAPPING

    for mapping in (dict(DEFAULT_FIELD_MAPPING),
                    {"title": (0, 0, "text"), "color": (1, 1, "category")}):
        got = builders.build_triplet_dict(items, mapping)
        assert got == jax_builders.build_triplet_dict(items, mapping)
    assert got["A1"] == {"title": "Product 1", "color": "red"}
    for images in (None, [], [{"variant": "MAIN", "hi_res": "h"}],
                   [{"variant": "PT01", "large": "x"}]):
        assert builders.extract_main_image(images) == \
            jax_builders.extract_main_image(images)


@pytest.mark.parametrize("seed", [42, 7])
def test_sample_builders_match_jax(raw, seed):
    rows = builders.load_interactions(str(raw / "x.inter"))
    assert rows == jax_builders.load_interactions(str(raw / "x.inter"))
    seqs = builders.user_sequences(rows)
    assert seqs == jax_builders.user_sequences(rows)
    new = builders.create_new_user_samples(seqs, 20, 6, 15, seed)
    assert new == jax_builders.create_new_user_samples(seqs, 20, 6, 15, seed)
    assert len(new) == 20 and all(s["ground_truth"] in s["candidate"]
                                  for s in new)
    old = builders.create_old_user_samples(seqs, 12, 15, seed)
    assert old == jax_builders.create_old_user_samples(seqs, 12, 15, seed)
    split = builders.train_test_split(new, 0.25, seed)
    assert split == jax_builders.train_test_split(new, 0.25, seed)
    with pytest.raises(ValueError, match="not enough users"):
        builders.create_new_user_samples(seqs, 10 * N_USERS)


def _both(raw, tmp_path, argv):
    """Run one subcommand through both CLIs into sibling directories."""
    outs = {}
    for name, cli in (("port", port_cli), ("jax", jax_cli)):
        out = tmp_path / name
        out.mkdir(exist_ok=True)
        args = [a.replace("{out}", str(out)).replace("{raw}", str(raw))
                for a in argv]
        assert cli.main(args) == 0
        outs[name] = out
    return outs["port"], outs["jax"]


@pytest.mark.parametrize("argv,files", [
    (["item-dict", "--input", "{raw}/meta.jsonl", "--output",
      "{out}/items.json"], ["items.json"]),
    (["review-dict", "--input", "{raw}/reviews.jsonl", "--output",
      "{out}/reviews.json"], ["reviews.json"]),
    (["rec-new-user", "--inter", "{raw}/x.inter", "--output-prefix",
      "{out}/new", "--num-samples", "20", "--hist-len", "6",
      "--num-candidates", "15", "--seed", "3"],
     ["new_train_LRanker.json", "new_test_LRanker.json"]),
    (["rec-old-user", "--inter", "{raw}/x.inter", "--output-prefix",
      "{out}/old", "--num-candidates", "15"],
     ["old_train.json", "old_test.json"]),
], ids=["item-dict", "review-dict", "rec-new-user", "rec-old-user"])
def test_data_subcommands_write_the_jax_files(raw, tmp_path, argv, files):
    port, jax = _both(raw, tmp_path, argv)
    for name in files:
        assert (port / name).read_bytes() == (jax / name).read_bytes(), name
        assert json.loads((port / name).read_text())


def test_triplet_dict_subcommand_writes_the_jax_file(raw, tmp_path):
    """With the default schema and with a ``--config`` YAML."""
    port_cli.main(["item-dict", "--input", str(raw / "meta.jsonl"),
                   "--output", str(tmp_path / "items.json")])
    (tmp_path / "schema.yaml").write_text(
        "FIELD_MAPPING:\n  title: [0, 0, text]\n  brand: [1, 1, category]\n"
        "  main_image: [2, 2, image]\n  price: [3, 3, number]\n")
    for extra in ([], ["--config", str(tmp_path / "schema.yaml")]):
        argv = ["triplet-dict", "--input", str(tmp_path / "items.json"),
                "--output", "{out}/triplet.json"] + extra
        port, jax = _both(raw, tmp_path, argv)
        assert (port / "triplet.json").read_bytes() == \
            (jax / "triplet.json").read_bytes()
    triplet = json.loads((port / "triplet.json").read_text())
    assert triplet["A1"] == {"title": "Product 1", "brand": "B1",
                             "main_image": "http://x/1.jpg", "price": 4.5}
    assert triplet["A0"]["main_image"] == "http://x/0h"  # hi_res fallback
