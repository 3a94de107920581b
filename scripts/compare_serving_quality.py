"""The serving gate's modes on the port against the JAX package's
``Recommender``, on the CPU, at the production widths with the depth and
the vocabulary cut (C-18): ``Qwen3Config()`` but ``--layers`` decoder
layers and a 4,096-token vocabulary, ``ItemQFormerConfig(num_query_tokens
=2)`` at 2 layers, seq ``--seq``, ``--users`` users at batch 8 over 500
items, from the same Flax-initialised weights (carried across with
``utils/weights.joint_state_dict_from_flax``) and the same histories
(``measure_serving_quality.serving_data``).

Prints, for each mode (the fp32 oracle, bf16, int8_xla, int8_fused), the
port's user embeddings against JAX's, and each package's per-user cosine
against its own fp32 oracle: the two packages' distance from the oracle is
the same function's.  Run on the CPU only; the full 28-layer model is the
card's (``chip_smoke.py`` ``phase_quality``).

    JAX_PLATFORMS=cpu python scripts/compare_serving_quality.py [--layers 4]
        [--users 16] [--seq 512]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from unirec_tpu import configs as jcfg  # noqa: E402
from unirec_tpu.data.cache import FieldEmbeddingCache as JaxCache  # noqa: E402
from unirec_tpu.data.tokenizer import HashTokenizer as JaxTokenizer  # noqa: E402
from unirec_tpu.models.joint import MultiModalQwenEmbedding as JaxJoint  # noqa: E402
from unirec_tpu.serving.recommender import Recommender as JaxRecommender  # noqa: E402
from unirec_tpu_torch import configs as pcfg  # noqa: E402
from unirec_tpu_torch.models.joint import MultiModalQwenEmbedding  # noqa: E402
from unirec_tpu_torch.scripts import measure_serving_quality as ms  # noqa: E402
from unirec_tpu_torch.utils.weights import joint_state_dict_from_flax  # noqa: E402

VOCAB, ITEMS, BATCH = 4096, 500, 8


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--users", type=int, default=16)
    p.add_argument("--seq", type=int, default=512)
    args = p.parse_args()
    jax.config.update("jax_platforms", "cpu")
    kw = dict(num_hidden_layers=args.layers, vocab_size=VOCAB)
    qwen, pqwen = jcfg.Qwen3Config(**kw), pcfg.Qwen3Config(**kw)
    qf = jcfg.ItemQFormerConfig(num_query_tokens=2, num_hidden_layers=2)
    pqf = pcfg.ItemQFormerConfig(num_query_tokens=2, num_hidden_layers=2)
    jc = jcfg.JointModelConfig(max_length=args.seq)
    pjc = pcfg.JointModelConfig(max_length=args.seq)
    cache, catalog, item_dict, tok, hists = ms.serving_data(
        pqwen, pqf, pjc, ITEMS, args.users)

    model32 = JaxJoint(qwen, qf, jc, lora=jcfg.LoRAConfig(), dtype=jnp.float32)
    params = jax.jit(model32.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, args.seq), jnp.int32),
        jnp.ones((1, args.seq)),
        jnp.zeros((1, jc.num_history_items, qf.num_fields,
                   qf.field_embedding_dim)),
        jnp.ones((1, jc.num_history_items, qf.num_fields)))
    model_bf16 = JaxJoint(qwen, qf, jc, lora=jcfg.LoRAConfig(),
                          dtype=jnp.bfloat16)
    jcache = JaxCache(cache.embeddings, cache.masks, cache.fields,
                      cache.item_ids)
    jtok = JaxTokenizer(qwen.vocab_size, jc.num_history_items,
                        jc.num_query_tokens_per_item)
    t0 = time.perf_counter()
    want = {}
    for label, model, mode in [("fp32", model32, {})] + [
            (label, model_bf16, mode) for label, mode in ms.MODES.items()]:
        rec = JaxRecommender(model, params, jtok, item_dict, jcache, catalog,
                             batch_size=BATCH, **mode)
        want[label] = np.asarray(rec.encode_users(hists), np.float32)
    print(f"JAX: {time.perf_counter() - t0:.1f} s", flush=True)

    port = MultiModalQwenEmbedding(pqwen, pqf, pjc, lora=pcfg.LoRAConfig())
    port.load_state_dict(joint_state_dict_from_flax(params, qwen, qf))
    t0 = time.perf_counter()
    got = ms.encode_modes(port, tok, item_dict, cache, catalog, hists, BATCH,
                          log=lambda msg: None)
    print(f"port: {time.perf_counter() - t0:.1f} s", flush=True)
    for label in got:
        cos = ms.user_cosines(got[label], want[label])
        print(f"{label}: port vs JAX cosine mean {cos.mean():.7f} min "
              f"{cos.min():.7f}", flush=True)
    for label in ms.MODES:
        pc = ms.user_cosines(got[label], got["fp32"])
        jc_ = ms.user_cosines(want[label], want["fp32"])
        print(f"{label} vs its fp32 oracle: port mean {pc.mean():.6f} min "
              f"{pc.min():.6f}; JAX mean {jc_.mean():.6f} min "
              f"{jc_.min():.6f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
