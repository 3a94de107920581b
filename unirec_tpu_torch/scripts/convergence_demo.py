"""Convergence demo on the port: the item, user and joint stages trained to
convergence on a seeded synthetic All_Beauty-shaped corpus (port of the
``unirec_tpu`` side of ``scripts/convergence_demo.py``).

The corpus has learnable latent structure: item fields, candidate
embeddings and user histories all derive from one latent per item
(``make_corpus``, the JAX script's numpy code: the same arrays bit for bit).
Each stage trains from the port's seeded initialisers on the JAX stage's
batches, configs, step counts and learning rates, and reports what the JAX
stage reports for ``unirec_tpu``:

* item stage: held-out masked reconstruction MSE and mean cosine over valid
  fields (``train/item_qformer.ItemQFormerTrainer.evaluate``, i.e.
  ``eval/reconstruction.py``);
* user stage: MSE and cosine of the predicted next-item tokens over held-out
  sliding windows, against the predict-zero baseline;
* joint stage: MRR / Recall@10 / NDCG@10 over 100-candidate pools
  (``train/joint.JointTrainer.evaluate``), before and after training.

The JAX script also trains the reference framework side by side; that half
needs the reference checkout and has no counterpart here.

    python -m unirec_tpu_torch.scripts.convergence_demo [--scaled] [--device cpu]

Prints one JSON line per stage.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from unirec_tpu_torch.configs import (
    ItemQFormerConfig,
    JointModelConfig,
    LoRAConfig,
    MeshConfig,
    OptimizerConfig,
    Qwen3Config,
    TrainConfig,
    UserQFormerConfig,
)
from unirec_tpu_torch.data.cache import FieldEmbeddingCache
from unirec_tpu_torch.data.tokenizer import HashTokenizer
from unirec_tpu_torch.scripts import full_fp32

HIDDEN, LAYERS, HEADS, FFN, WIDTH, F = 64, 2, 4, 128, 48, 6
N_ITEMS, N_USERS, LATENT = 240, 160, 16
K_ITEM = 8  # item-stage query tokens (production: 32, ``--scaled``)
VOCAB = 128
STEPS = {"item": 400, "user": 300, "joint": 800}
# --scaled: 2k items / 1k users, the production field count (F = 14) and
# item query-token count (K = 32), step counts scaled with the corpus
SCALED = dict(n_items=2000, n_users=1000, f=14)
SCALED_K_ITEM = 32
SCALED_STEPS = {"item": 1200, "user": 600, "joint": 1600}


# ---------------------------------------------------------------------------
# Synthetic corpus with learnable latent structure
# ---------------------------------------------------------------------------


def make_corpus(seed: int = 0, n_items: int = N_ITEMS, n_users: int = N_USERS,
                f: int = F):
    """(field cache, candidate embeddings by id, item dict, users, fields
    [n_items, f, WIDTH], masks [n_items, f]): the JAX script's corpus."""
    rng = np.random.RandomState(seed)
    z = rng.randn(n_items, LATENT).astype(np.float32)
    field_maps = (rng.randn(f, LATENT, WIDTH) / np.sqrt(LATENT)).astype(np.float32)
    fields = np.einsum("nl,flw->nfw", z, field_maps).astype(np.float32)
    fields += (0.1 * rng.randn(*fields.shape)).astype(np.float32)
    masks = (rng.rand(n_items, f) > 0.15).astype(np.float32)
    masks[:, 0] = 1.0
    fields *= masks[..., None]

    # candidate-pool target embeddings share the latent (so ranking is
    # learnable): E = z @ B, unit-normalized
    emb_map = (rng.randn(LATENT, HIDDEN) / np.sqrt(LATENT)).astype(np.float32)
    cand = (z @ emb_map).astype(np.float32)
    cand /= np.linalg.norm(cand, axis=-1, keepdims=True)

    # users walk a preference direction; histories + gt sampled by affinity
    users = []
    for _ in range(n_users):
        pref = rng.randn(LATENT).astype(np.float32)
        logits = z @ pref * 1.5
        p = np.exp(logits - logits.max())
        p /= p.sum()
        seq = rng.choice(n_items, size=12, replace=False, p=p)
        gt = seq[-1]
        negs = rng.choice(
            [i for i in range(n_items) if i != gt], size=99, replace=False
        )
        users.append(
            {
                "history": [f"i{k}" for k in seq[:-1]],
                "ground_truth": f"i{gt}",
                "candidate": [f"i{gt}"] + [f"i{k}" for k in negs],
            }
        )
    cache = FieldEmbeddingCache(
        embeddings=fields,
        masks=masks,
        fields=[f"f{j}" for j in range(f)],
        item_ids=[f"i{k}" for k in range(n_items)],
    )
    emb_dict = {f"i{k}": cand[k].tolist() for k in range(n_items)}
    item_dict = {f"i{k}": {"title": f"Synthetic product {k}"} for k in range(n_items)}
    return cache, emb_dict, item_dict, users, fields, masks


# ---------------------------------------------------------------------------
# Stage 1: item Q-Former to convergence
# ---------------------------------------------------------------------------


def item_stage(cache: FieldEmbeddingCache, users: Sequence[Dict],
               fields: np.ndarray, masks: np.ndarray, steps: int = 400,
               batch: int = 64, lr: float = 1e-3, seed: int = 1,
               k_item: int = K_ITEM, device=None) -> Dict:
    """Masked reconstruction + triplet training on consecutive history
    pairs (the shipped trainer's step), 90/10 item split for held-out
    evaluation."""
    from unirec_tpu_torch.train.item_qformer import ItemQFormerTrainer

    full_fp32()
    n_items = len(fields)
    cfg = ItemQFormerConfig(
        hidden_size=HIDDEN, num_hidden_layers=LAYERS,
        num_attention_heads=HEADS, intermediate_size=FFN,
        num_query_tokens=k_item, field_embedding_dim=WIDTH,
        num_fields=fields.shape[1], dropout=0.0,
    )
    trainer = ItemQFormerTrainer(cfg, TrainConfig(
        batch_size=batch, seed=seed,
        optimizer=OptimizerConfig(learning_rate=lr, weight_decay=0.01)),
        device=device)
    state = trainer.init_state()

    # triplets: consecutive history pairs; 90/10 item split for held-out eval
    rng = np.random.RandomState(seed)
    row = {f"i{k}": k for k in range(n_items)}
    perm = rng.permutation(n_items)
    val_rows = np.sort(perm[: n_items // 10])
    val_set = set(val_rows.tolist())
    pairs = [
        (row[u["history"][i]], row[u["history"][i + 1]])
        for u in users
        for i in range(len(u["history"]) - 1)
        if row[u["history"][i]] not in val_set
        and row[u["history"][i + 1]] not in val_set
    ]
    pairs = np.asarray(pairs, np.int32)

    for _ in range(steps):
        idx = rng.randint(0, len(pairs), batch)
        anc, pos = pairs[idx, 0], pairs[idx, 1]
        neg = rng.randint(0, n_items, batch)
        b = {
            "anchor_emb": fields[anc], "anchor_mask": masks[anc],
            "pos_emb": fields[pos], "pos_mask": masks[pos],
            "neg_emb": fields[neg], "neg_mask": masks[neg],
        }
        state, _ = trainer._train_step(state, b)

    val = trainer.evaluate(state, cache, val_rows)
    return {
        "stage": "item",
        "steps": steps,
        "unirec_tpu_torch": {
            "val_recon_mse": round(val["val_recon_loss"], 4),
            "val_cosine": round(val["avg_cosine_similarity"], 4)},
    }


# ---------------------------------------------------------------------------
# Stage 1.5: user Q-Former to convergence
# ---------------------------------------------------------------------------


def user_stage(users: Sequence[Dict], fields: np.ndarray, masks: np.ndarray,
               steps: int = 300, batch: int = 32, lr: float = 1e-3,
               seed: int = 3, device=None) -> Dict:
    """Next-item token prediction (reference: user_qformer_training.py:17-68,
    199-213 -- MSE between UserQFormer(seq) and the next item's query
    tokens, AdamW).  Item tokens are a fixed linear image of the corpus
    fields, so they inherit the latent preference structure and the next
    item is learnable from the history."""
    from unirec_tpu_torch.train.common import make_optimizer
    from unirec_tpu_torch.utils.device import resolve_device
    from unirec_tpu_torch.utils.weights import init_user_qformer

    full_fp32()
    device = resolve_device(device)
    n_items, f = fields.shape[:2]
    k_pred, l_items = 4, 8  # tokens per item; max history items in a window
    rng = np.random.RandomState(seed)
    proj = (rng.randn(f * WIDTH, k_pred * HIDDEN)
            / np.sqrt(f * WIDTH)).astype(np.float32)
    tokens = (
        (fields * masks[..., None]).reshape(n_items, f * WIDTH) @ proj
    ).reshape(n_items, k_pred, HIDDEN) * 3.0

    row = {f"i{k}": k for k in range(n_items)}
    split = int(0.9 * len(users))

    def windows(us):
        seq_len = l_items * k_pred
        inp, msk, tgt = [], [], []
        for u in us:
            hist = [row[i] for i in u["history"]]
            for j in range(3, len(hist)):
                ctx = hist[max(0, j - l_items): j]
                x = np.zeros((seq_len, HIDDEN), np.float32)
                m = np.zeros((seq_len,), np.float32)
                flat = tokens[ctx].reshape(-1, HIDDEN)
                x[: len(flat)] = flat
                m[: len(flat)] = 1.0
                inp.append(x)
                msk.append(m)
                tgt.append(tokens[hist[j]])
        return (np.stack(inp), np.stack(msk), np.stack(tgt))

    tr_inp, tr_msk, tr_tgt = windows(users[:split])
    va_inp, va_msk, va_tgt = windows(users[split:])

    ucfg = UserQFormerConfig(
        hidden_size=HIDDEN, num_hidden_layers=LAYERS,
        num_attention_heads=HEADS, intermediate_size=FFN,
        num_query_tokens=8, input_embedding_dim=HIDDEN,
        num_item_tokens_to_predict=k_pred, dropout=0.0,
    )
    model = init_user_qformer(ucfg, torch.Generator(device).manual_seed(seed),
                              device=device).user.train()
    params = dict(model.named_parameters())
    # reference: optim.AdamW(model.parameters(), lr=...) -- default wd 0.01
    opt = make_optimizer(params, OptimizerConfig(learning_rate=lr,
                                                 weight_decay=0.01))

    def t(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    for _ in range(steps):
        idx = rng.randint(0, len(tr_inp), batch)
        for p in params.values():
            p.grad = None
        pred = model(t(tr_inp[idx]), t(tr_msk[idx]))
        torch.mean((pred - t(tr_tgt[idx])) ** 2).backward()
        opt.step({n: p.grad if p.grad is not None else torch.zeros_like(p)
                  for n, p in params.items()})

    model.eval()
    with torch.no_grad():
        pred = model(t(va_inp), t(va_msk)).float().cpu().numpy()
    mse = float(np.mean((pred - va_tgt) ** 2))
    o = va_tgt / np.maximum(np.linalg.norm(va_tgt, axis=-1, keepdims=True),
                            1e-12)
    r = pred / np.maximum(np.linalg.norm(pred, axis=-1, keepdims=True), 1e-12)
    base = float(np.mean(va_tgt ** 2))  # predict-zero baseline
    return {
        "stage": "user",
        "steps": steps,
        "val_windows": len(va_inp),
        "predict_zero_mse": round(base, 4),
        "unirec_tpu_torch": {"val_pred_mse": round(mse, 4),
                             "val_token_cosine": round(
                                 float(np.mean((o * r).sum(-1))), 4)},
    }


# ---------------------------------------------------------------------------
# Stage 2: joint Qwen3+LoRA to convergence
# ---------------------------------------------------------------------------


def joint_trainer(num_fields: int, batch: int = 8, lr: float = 1e-3,
                  seed: Optional[int] = None, int8_base: bool = False,
                  device=None):
    """The joint stage's trainer (float32): a 2-layer Qwen3 of 2 KV heads
    of 16, LoRA r 4, a 2-query-token Item Q-Former, ``max_length`` 96,
    AdamW with 5 warmup steps and clipping at 1.0.  ``seed`` None: the
    ``TrainConfig`` default, as the JAX joint stage."""
    from unirec_tpu_torch.train.joint import JointTrainer

    full_fp32()
    qc = Qwen3Config(
        vocab_size=VOCAB, hidden_size=HIDDEN, intermediate_size=FFN,
        num_hidden_layers=LAYERS, num_attention_heads=HEADS,
        num_key_value_heads=2, head_dim=16, flash_attention=False,
    )
    icfg = ItemQFormerConfig(
        hidden_size=HIDDEN, num_hidden_layers=LAYERS,
        num_attention_heads=HEADS, intermediate_size=FFN,
        num_query_tokens=2, field_embedding_dim=WIDTH, num_fields=num_fields,
        dropout=0.0,
    )
    opt = OptimizerConfig(learning_rate=lr, weight_decay=0.0, warmup_steps=5,
                          max_grad_norm=1.0)
    kw = {} if seed is None else dict(seed=seed)
    return JointTrainer(
        qc, icfg, JointModelConfig(max_length=96),
        lora=LoRAConfig(r=4, alpha=8.0, dropout=0.0),
        train_config=TrainConfig(batch_size=batch, optimizer=opt,
                                 mesh=MeshConfig(dp=1), **kw),
        int8_base=int8_base, device=device)


def joint_datasets(trainer, cache: FieldEmbeddingCache, emb_dict: Dict,
                   item_dict: Dict, users: Sequence[Dict]):
    """(train, test) datasets: an 80/20 user split (reference split rule,
    process_rec_new_user.py:118), 10 negatives to train on, the whole
    100-candidate pools to test on."""
    from unirec_tpu_torch.train.joint import JointDataset

    jc = trainer.joint_config
    tok = HashTokenizer(VOCAB, jc.num_history_items,
                        jc.num_query_tokens_per_item)
    split = int(0.8 * len(users))
    return tuple(
        JointDataset(part, emb_dict, tok, item_dict, cache, jc,
                     max_negatives=negs, item_emb_dim=HIDDEN)
        for part, negs in ((users[:split], 10), (users[split:], 99)))


def rank_metrics(trainer, state, test_ds) -> Dict[str, float]:
    """MRR, Recall@10 and NDCG@10 over the full candidate pools."""
    m = trainer.evaluate(state, test_ds, batch_size=16, max_negatives=99,
                         ks=(10,))
    return {k: float(m[k]) for k in ("mrr", "recall@10", "ndcg@10")}


def rounded(metrics: Dict[str, float]) -> Dict[str, float]:
    """To 4 digits, as the JAX scripts print them."""
    return {k: round(v, 4) for k, v in metrics.items()}


def joint_stage(cache: FieldEmbeddingCache, emb_dict: Dict, item_dict: Dict,
                users: Sequence[Dict], steps: int = 800, batch: int = 8,
                lr: float = 1e-3, seed: int = 2, device=None) -> Dict:
    trainer = joint_trainer(cache.num_fields, batch, lr, device=device)
    state = trainer.init_state()
    train_ds, test_ds = joint_datasets(trainer, cache, emb_dict, item_dict,
                                       users)
    init_metrics = rounded(rank_metrics(trainer, state, test_ds))
    rng = np.random.RandomState(seed)
    for _ in range(steps):
        idx = rng.randint(0, len(train_ds), batch)
        state, _ = trainer._train_step(state, train_ds.batch(idx.tolist()))
    return {
        "stage": "joint",
        "steps": steps,
        "test_users": len(test_ds),
        "untrained_init": init_metrics,
        "unirec_tpu_torch": rounded(rank_metrics(trainer, state, test_ds)),
    }


def main(argv=None) -> int:
    from unirec_tpu_torch.utils.device import resolve_device

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument(
        "--scaled", action="store_true",
        help="one notch up: 2k items / 1k users, the production field count "
        "(F=14) and item query-token count (K=32); step counts scaled with "
        "the corpus")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    corpus, k_item, steps = {}, K_ITEM, STEPS
    if args.scaled:
        corpus, k_item, steps = SCALED, SCALED_K_ITEM, SCALED_STEPS

    cache, emb_dict, item_dict, users, fields, masks = make_corpus(**corpus)
    r1 = item_stage(cache, users, fields, masks, steps=steps["item"],
                    k_item=k_item, device=device)
    print(json.dumps(r1), flush=True)
    r15 = user_stage(users, fields, masks, steps=steps["user"], device=device)
    print(json.dumps(r15), flush=True)
    r2 = joint_stage(cache, emb_dict, item_dict, users, steps=steps["joint"],
                     device=device)
    print(json.dumps(r2), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
