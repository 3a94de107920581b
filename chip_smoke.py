"""Smoke run of the PyTorch port's serving path on one NVIDIA Hopper GPU.

    python3 chip_smoke.py

Phases (any failed check raises; the script then exits non-zero):

1. device: ``nvidia-smi`` name and power limit, torch's device name and
   compute capability.  No CUDA device of capability (9, 0) -> exit 2.
2. build: the hand-written CUDA kernels from ``unirec_tpu_torch/csrc`` (nvcc
   for sm_90a, ``-Xptxas -v`` printed).
3. kernels vs plain versions at the slice's shapes, timed with CUDA events:
   K1 causal GQA flash attention (B=8, L=512, 16/8 heads, hd 128, row lengths
   1..512) in fp32 and bf16; K2 blocked top-k retrieval (8 and 64 users,
   20,000 x 1,024 catalog, k=20).
4. the serving slice at full width (Qwen3-0.6B, 28 layers; 12-layer Item
   Q-Former with K=2; LoRA r=16 with nonzero lora_b; L=512; bf16; random
   weights from seed 0): 24 concurrent HTTP ``/recommend`` requests through
   ``make_server``, answers checked against direct ``recommend`` calls, both
   kernels' launch counters checked, both kernels compared with their plain
   versions on the tensors the served run fed them.
5. last line: ``{"ok": true, "device": {...}}``.

TF32 stays off for both matmul flags: float32 products are full precision,
so the fp32 tolerances below hold.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SEED = 0
K1_SHAPE = dict(B=8, L=512, HQ=16, HKV=8, HD=128)
K2_USERS = (8, 64)
CATALOG, DIM, K2_K = 20_000, 1_024, 20
N_REQUESTS, SERVE_K, BATCH = 24, 10, 8
K1_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
K2_TIE, K2_SCORE_TOL = 1e-6, 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- K1 ---------------------------------------------------------------------


def k1_error(q, k, v, mask, hq, hkv):
    """(max|kernel - ref|, max|ref|); ref = plain version in fp32 on the same
    (possibly bf16-rounded) inputs."""
    from unirec_tpu_torch.ops.flash_causal import (
        flash_causal_attention,
        flash_causal_attention_plain,
    )

    out = flash_causal_attention(q, k, v, mask, hq, hkv)
    torch.cuda.synchronize()
    ref = flash_causal_attention_plain(q.float(), k.float(), v.float(), mask,
                                       hq, hkv)
    return (out.float() - ref).abs().max().item(), ref.abs().max().item()


def check_k1(err: float, ref_max: float, dtype, where: str) -> None:
    rel = err / ref_max
    log(f"K1 {where} {dtype}: max|d| {err:.3e} max|ref| {ref_max:.3e} "
        f"rel {rel:.3e} (tol {K1_TOL[dtype]:g})")
    if not rel <= K1_TOL[dtype]:
        raise AssertionError(f"K1 {where} {dtype} disagrees: rel {rel}")


def phase_k1(gen) -> dict:
    from unirec_tpu_torch.ops.flash_causal import (
        flash_causal_attention,
        flash_causal_attention_plain,
    )

    b, l, hq, hkv, hd = (K1_SHAPE[x] for x in ("B", "L", "HQ", "HKV", "HD"))
    lengths = torch.tensor([1, 7, 64, 65, 200, 333, 511, 512], device="cuda")
    mask = (torch.arange(l, device="cuda")[None] < lengths[:, None]).float()
    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(b, l, hq * hd, device="cuda", generator=gen).to(dtype)
        k = torch.randn(b, l, hkv * hd, device="cuda", generator=gen).to(dtype)
        v = torch.randn(b, l, hkv * hd, device="cuda", generator=gen).to(dtype)
        check_k1(*k1_error(q, k, v, mask, hq, hkv), dtype, "phase 3")
        kern = time_ms(lambda: flash_causal_attention(q, k, v, mask, hq, hkv))
        plain = time_ms(
            lambda: flash_causal_attention_plain(q, k, v, mask, hq, hkv))
        kern2 = time_ms(lambda: flash_causal_attention(q, k, v, mask, hq, hkv))
        times[dtype] = (min(kern, kern2), plain)
        log(f"K1 time {dtype} B={b} L={l} Hq={hq} Hkv={hkv} hd={hd}: kernel "
            f"{kern:.4f} / {kern2:.4f} ms, plain {plain:.4f} ms")
    return times


# -- K2 ---------------------------------------------------------------------


def k2_compare(users, catalog, k):
    """Kernel vs plain retrieval; returns the max score difference."""
    from unirec_tpu_torch.ops.losses import l2_normalize
    from unirec_tpu_torch.ops.ranking import retrieve_top_k, top_k_items

    s, i = retrieve_top_k(users, catalog, k=k)
    torch.cuda.synchronize()
    s_ref, i_ref = top_k_items(users, catalog, k=k)
    full = l2_normalize(users.float()) @ l2_normalize(catalog.float()).T
    score_err = (s - s_ref).abs().max().item()
    if not score_err <= K2_SCORE_TOL:
        raise AssertionError(f"K2 scores differ by {score_err}")
    diff = i != i_ref
    if diff.any():  # only near-ties may swap: the kernel's pick must score
        picked = full.gather(1, i)  # within K2_TIE of the rank's true score
        gap = (picked - s_ref)[diff].abs().max().item()
        if not gap < K2_TIE:
            raise AssertionError(f"K2 ids differ beyond near-ties ({gap})")
    log(f"K2 users={users.shape[0]} N={catalog.shape[0]} k={k}: "
        f"max|d score| {score_err:.3e}, id mismatches {int(diff.sum())} "
        f"(near-ties only)")
    return score_err


def phase_k2(gen) -> dict:
    from unirec_tpu_torch.ops.losses import l2_normalize
    from unirec_tpu_torch.ops.ranking import retrieve_top_k, top_k_items

    catalog = torch.randn(CATALOG, DIM, device="cuda", generator=gen)
    cat_n = l2_normalize(catalog)
    times = {}
    for n_users in K2_USERS:
        users = torch.randn(n_users, DIM, device="cuda", generator=gen)
        k2_compare(users, catalog, K2_K)
        u_n = l2_normalize(users)
        kern = time_ms(lambda: retrieve_top_k(users, catalog, k=K2_K))
        plain = time_ms(lambda: top_k_items(users, catalog, k=K2_K))
        bare = time_ms(lambda: retrieve_top_k(u_n, cat_n, k=K2_K,
                                              normalize=False))
        bare_plain = time_ms(lambda: top_k_items(u_n, cat_n, k=K2_K,
                                                 normalize=False))
        kern2 = time_ms(lambda: retrieve_top_k(users, catalog, k=K2_K))
        times[n_users] = (min(kern, kern2), plain)
        log(f"K2 time users={n_users}: with normalisation kernel {kern:.4f} / "
            f"{kern2:.4f} ms, plain {plain:.4f} ms; pre-normalised kernel "
            f"{bare:.4f} ms, plain {bare_plain:.4f} ms")
    return times


# -- phase 4: the serving slice ----------------------------------------------


def build_stack():
    from unirec_tpu.configs import (
        ItemQFormerConfig,
        JointModelConfig,
        LoRAConfig,
        Qwen3Config,
    )
    from unirec_tpu.data.cache import FieldEmbeddingCache
    from unirec_tpu_torch.data.tokenizer import HashTokenizer
    from unirec_tpu_torch.serving.recommender import Recommender
    from unirec_tpu_torch.utils.weights import init_joint

    qwen, qf = Qwen3Config(), ItemQFormerConfig(num_query_tokens=2)
    jc = JointModelConfig(max_length=512)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    model = init_joint(qwen, qf, jc, LoRAConfig(), gen, device="cuda",
                       dtype=torch.bfloat16, lora_b_std=0.02)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model: Qwen3 {qwen.num_hidden_layers} layers x {qwen.hidden_size}, "
        f"vocab {qwen.vocab_size}+{model.num_special_tokens}; Item Q-Former "
        f"{qf.num_hidden_layers} layers K={qf.num_query_tokens} "
        f"F={qf.num_fields}; LoRA r=16 nonzero lora_b; {n_params} parameters "
        f"bf16; built in {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    item_ids = [f"item{j}" for j in range(CATALOG)]
    emb = rng.standard_normal((CATALOG, qf.num_fields, qf.field_embedding_dim),
                              dtype=np.float32)
    masks = (rng.random((CATALOG, qf.num_fields)) > 0.15).astype(np.float32)
    masks[:, 0] = 1.0
    emb *= masks[..., None]  # a missing field has a zero embedding
    cache = FieldEmbeddingCache(emb, masks, [f"f{i}" for i in range(14)],
                                item_ids)
    cat = rng.standard_normal((CATALOG, DIM), dtype=np.float32)
    catalog = dict(zip(item_ids, cat))
    words = ["serum", "lip", "balm", "cherry", "matte", "gloss", "travel",
             "size", "vitamin", "mask", "oil", "brush", "set", "mini", "rose"]
    item_dict = {
        iid: {"title": " ".join(rng.choice(words, rng.integers(3, 12)))}
        for iid in item_ids
    }
    tok = HashTokenizer(qwen.vocab_size, jc.num_history_items,
                        jc.num_query_tokens_per_item)
    rec = Recommender(model, tok, item_dict, cache, catalog, batch_size=BATCH)
    log(f"data: field cache {CATALOG} x {qf.num_fields} x "
        f"{qf.field_embedding_dim} on device as bf16 "
        f"({rec._cache_emb_dev.numel() * 2 / 1e9:.3f} GB), "
        f"{int((masks == 0).sum())} missing fields; catalog {CATALOG} x {DIM}; "
        f"made in {time.perf_counter() - t0:.1f} s")
    return rec, item_ids, rng


def post(url: str, payload: dict):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=300) as resp:
        return resp.status, json.loads(resp.read())


def phase_serve(smi: str) -> dict:
    from unirec_tpu_torch.ops.flash_causal import flash_causal_attention
    from unirec_tpu_torch.ops.losses import l2_normalize
    from unirec_tpu_torch.ops.ranking import retrieve_top_k
    from unirec_tpu_torch.serving.server import make_server

    rec, item_ids, rng = build_stack()
    histories = [
        [str(x) for x in rng.choice(item_ids, n, replace=False)]
        for n in (np.arange(N_REQUESTS) % 13)  # history lengths 0..12
    ]
    torch.cuda.reset_peak_memory_stats()
    # admit the whole burst: the default admission bound (two batches) would
    # shed a third of it with 503s
    server, batcher = make_server(rec, port=0, warmup=True,
                                  max_queued=N_REQUESTS)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    # capture what the served run feeds the kernels: layer 0's attention
    # inputs and the batch's pooled user embeddings (last batch wins)
    seen = {}
    attn0 = rec.model.base_model.layers[0].self_attn
    hooks = [
        attn0.register_forward_pre_hook(
            lambda mod, args: seen.__setitem__("attn0", args)),
        rec.model.register_forward_hook(
            lambda mod, args, out: seen.__setitem__("pooled", out)),
    ]
    try:
        flash_causal_attention.launches = 0
        retrieve_top_k.launches = 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=N_REQUESTS) as pool:
            answers = list(pool.map(
                lambda h: post(f"{base}/recommend", {"history": h,
                                                     "k": SERVE_K}),
                histories))
        burst_s = time.perf_counter() - t0
        launches = {"k1": flash_causal_attention.launches,
                    "k2": retrieve_top_k.launches}
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
    finally:
        for h in hooks:
            h.remove()
        server.shutdown()
        server.server_close()
        batcher.close()
        thread.join(timeout=30)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"served {N_REQUESTS} requests in {burst_s:.3f} s over HTTP "
        f"({health['batches_run']} batches, warmup included); launches "
        f"during the requests: K1 {launches['k1']}, K2 {launches['k2']}")
    if not (launches["k1"] > 0 and launches["k2"] > 0):
        raise AssertionError(f"a kernel was not launched: {launches}")

    direct = rec.recommend(histories, k=SERVE_K)
    for h, (status, out), want in zip(histories, answers, direct):
        items = out.get("items", [])
        ids = [r["item_id"] for r in items]
        scores = [r["score"] for r in items]
        if status != 200 or len(items) != SERVE_K:
            raise AssertionError(f"bad answer {status} {out}")
        if set(ids) & set(h):
            raise AssertionError("a history item was recommended")
        if scores != sorted(scores, reverse=True) or not all(
                -1.0 <= s <= 1.0 for s in scores):
            raise AssertionError(f"bad scores {scores}")
        if ids != [r.item_id for r in want]:
            raise AssertionError(f"HTTP answer differs from recommend(): "
                                 f"{ids} vs {[r.item_id for r in want]}")
        if not np.allclose(scores, [r.score for r in want], atol=1e-5, rtol=0):
            raise AssertionError("HTTP scores differ from recommend()")
    log(f"{N_REQUESTS}/{N_REQUESTS} HTTP answers valid: 200, {SERVE_K} items, "
        f"no history items, scores descending in [-1, 1], equal to direct "
        f"recommend(); healthz ok={health['ok']}")

    # K1 and K2 on the tensors the served run fed them
    c = rec.model.qwen_config
    with torch.no_grad():
        hidden, cos, sin, pad_mask = seen["attn0"]
        q, k, v = attn0.qkv(hidden, cos, sin)
        err, ref_max = k1_error(q, k, v, pad_mask, c.num_attention_heads,
                                c.num_key_value_heads)
        check_k1(err, ref_max, q.dtype, "served layer 0")
        users = l2_normalize(seen["pooled"]).float()
        k2_err = k2_compare(users, rec._catalog_dev,
                            SERVE_K + rec.jc.num_history_items)

    lat = []
    batch = histories[:BATCH]
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec.recommend(batch, k=SERVE_K)  # ends in a device-to-host copy
        lat.append(time.perf_counter() - t0)
    med = float(np.median(lat))
    log(f"[{smi}] direct recommend(), batch {BATCH}: per-batch latency "
        f"median {med * 1e3:.1f} ms (min {min(lat) * 1e3:.1f}, max "
        f"{max(lat) * 1e3:.1f}) over 5 batches = {BATCH / med:.1f} users/s; "
        f"HTTP burst {N_REQUESTS / burst_s:.1f} users/s; peak device memory "
        f"{peak_gb:.2f} GB (max_memory_allocated)")
    return {"launches": launches, "k1_err": err, "k2_err": k2_err}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    cap = torch.cuda.get_device_capability(0)
    if cap < (9, 0):
        print(f"chip_smoke: needs compute capability 9.0, got {cap}",
              file=sys.stderr)
        return 2
    # fp32 matmuls stay full precision (no TF32) for the fp32 tolerances
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import unirec_tpu_torch  # noqa: F401  (fails outside a checkout)
    from unirec_tpu_torch.ops._build import load_kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    name = torch.cuda.get_device_name(0)
    log(f"device: {name}, capability {cap}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    kern = load_kernels()
    log(f"build: {kern.path.name} from unirec_tpu_torch/csrc in "
        f"{kern.build_seconds:.1f} s (load {time.perf_counter() - t0:.1f} s)")
    log(kern.ptxas_log.strip())

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    k1_times = phase_k1(gen)
    k2_times = phase_k2(gen)
    served = phase_serve(smi)

    k1_ms, k1_plain = k1_times[torch.bfloat16]
    k2_ms, k2_plain = k2_times[BATCH]
    log(json.dumps({"kernels": [
        {"name": "flash_causal_fwd", "route": "cuda",
         "source": "unirec_tpu_torch/csrc/flash_causal_fwd.cu",
         "replaces": "unirec_tpu/ops/flash_causal_vjp.py:78",
         "launches": served["launches"]["k1"],
         "max_abs_err": served["k1_err"], "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "retrieve_topk", "route": "cuda",
         "source": "unirec_tpu_torch/csrc/retrieve_topk.cu",
         "replaces": "unirec_tpu/ops/ranking.py:118",
         "launches": served["launches"]["k2"],
         "max_abs_err": served["k2_err"], "ms": k2_ms, "plain_ms": k2_plain},
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
