"""Where the port's int8 serving forward parts from the JAX package's, layer
by layer (C-18), on the CPU: the Qwen3 decoder stack at the production
widths (``Qwen3Config()``, vocabulary cut to 4,096) with ``--layers``
layers, ``--users`` prompts of ``--seq`` tokens (the last user's padded to
three quarters), one Flax initialisation carried to the port (tokens and
weights from ``--seed``).

Modes, as ``Recommender`` runs them: the fp32 oracle, bf16, int8_xla (the
seven projections per layer through ``int8_linear_ste`` with the LoRA
overlay live) and int8_fused (LoRA merged, q|k|v through B9a and the MLP
through B9b).  Both packages' forwards are jitted as the JAX
``Recommender`` jits its own.  For each mode and layer it prints, over the
unpadded rows, the mean distance 1 - cos of

  free     the port's layer output from JAX's, each running its own stack;
  forced   the port's layer from JAX's when the port's layer takes JAX's
           previous layer output as its input: one layer's own difference,
           and the fraction of rows that are equal bit for bit;
  oracle   each package's layer output from its own fp32 oracle's.

``--probe`` also compares, in the first layer, each sub-module's output
(norms, projections, attention, MLP) of the two packages on the same input.

    JAX_PLATFORMS=cpu python scripts/compare_int8_layers.py [--layers 28]
        [--users 4] [--seq 512] [--seed 0] [--probe]
"""

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from unirec_tpu import configs as jcfg  # noqa: E402
from unirec_tpu.models import qwen3 as jq  # noqa: E402
from unirec_tpu.utils.params import merge_lora_weights as jax_merge  # noqa: E402
from unirec_tpu_torch import configs as pcfg  # noqa: E402
from unirec_tpu_torch.models import qwen3 as pq  # noqa: E402
from unirec_tpu_torch.utils.weights import flax_to_state_dict  # noqa: E402
from unirec_tpu_torch.utils.params import merge_lora_weights  # noqa: E402

VOCAB = 4096
MODES = ("fp32", "bf16", "int8_xla", "int8_fused")


def _jax_layers(cfg, lora, dtype, variables, ids, mask, fused):
    """Each layer's output, and the first layer's sub-modules' outputs by
    their port names."""
    cfg = dataclasses.replace(cfg, fused_int8_inference=fused)
    model = jq.Qwen3Model(cfg, lora=lora, dtype=dtype)

    def run(v, i, m):
        _, state = model.apply(
            v, i, m, capture_intermediates=lambda mdl, name: (
                name == "__call__" and (isinstance(mdl, jq.Qwen3Layer)
                                        or mdl.path[:1] == ("layers_0",))),
            mutable=["intermediates"])
        inter = state["intermediates"]
        subs = {}

        def walk(tree, path):
            for key, val in tree.items():
                if key == "__call__":
                    subs[".".join(path)] = val[0]
                else:
                    walk(val, path + (key,))
        walk(inter["layers_0"], ())
        return [inter[f"layers_{n}"]["__call__"][0]
                for n in range(cfg.num_hidden_layers)], subs

    outs, subs = jax.jit(run)(variables, jnp.asarray(ids), jnp.asarray(mask))
    return ([np.asarray(o.astype(jnp.float32)) for o in outs],
            {k: np.asarray(v.astype(jnp.float32)) for k, v in subs.items()})


def _port_layers(cfg, lora, dtype, sd, ids, mask, fused, int8,
                 forced_inputs=None):
    cfg = dataclasses.replace(cfg, fused_int8_inference=fused)
    pm = pq.Qwen3Model(cfg, lora=lora, dtype=dtype, param_dtype=torch.float32)
    pm.load_state_dict(sd)
    if int8:
        pq.set_qweights(pm, pq.quantize_qwen3_weights(pm))
    outs, subs = {}, {}
    for name, mod in pm.layers[0].named_modules():
        if name:
            mod.register_forward_hook(
                lambda mod, a, out, name=name: subs.__setitem__(
                    name, out.float().clone()))
    for n, layer in enumerate(pm.layers):
        layer.register_forward_hook(
            lambda mod, a, out, n=n: outs.__setitem__(n, out.float().clone()))
        if forced_inputs is not None and n > 0:
            prev = torch.from_numpy(forced_inputs[n - 1]).to(dtype)
            layer.register_forward_pre_hook(
                lambda mod, a, prev=prev: (prev, *a[1:]))
    with torch.no_grad():
        pm(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    return ([outs[n].numpy() for n in range(cfg.num_hidden_layers)],
            {k: v.numpy() for k, v in subs.items()})


def _dist(a, b, rows):
    a, b = a.reshape(-1, a.shape[-1])[rows], b.reshape(-1, b.shape[-1])[rows]
    cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                            * np.linalg.norm(b, axis=1))
    return float((1.0 - cos).mean()), float((a == b).all(1).mean())


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--layers", type=int, default=28)
    p.add_argument("--users", type=int, default=4)
    p.add_argument("--seq", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--probe", action="store_true")
    args = p.parse_args()
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(os.cpu_count() or 1)
    kw = dict(num_hidden_layers=args.layers, vocab_size=VOCAB)
    jc, pc = jcfg.Qwen3Config(**kw), pcfg.Qwen3Config(**kw)
    jl, pl = jcfg.LoRAConfig(), pcfg.LoRAConfig()
    rng = np.random.RandomState(args.seed)
    ids = rng.randint(0, VOCAB, (args.users, args.seq)).astype(np.int32)
    mask = np.ones((args.users, args.seq), np.float32)
    mask[-1, 3 * args.seq // 4:] = 0.0
    rows = mask.reshape(-1) > 0
    params = jax.jit(jq.Qwen3Model(jc, lora=jl).init)(
        jax.random.PRNGKey(args.seed), jnp.asarray(ids[:1]),
        jnp.asarray(mask[:1]))
    merged = {"params": jax_merge(params["params"], jl.scaling)}
    sd = flax_to_state_dict(params)
    sd_merged = merge_lora_weights(sd, pl.scaling)
    setups = {  # JAX (lora, dtype, variables, fused), port (lora, sd, int8)
        "fp32": ((jl, jnp.float32, params, False), (pl, sd, False)),
        "bf16": ((jl, jnp.bfloat16, params, False), (pl, sd, False)),
        "int8_xla": ((jl, jnp.bfloat16, dict(
            params, qweights=jq.quantize_qwen3_weights(params["params"])),
            False), (pl, sd, True)),
        "int8_fused": ((None, jnp.bfloat16, dict(
            merged, qweights=jq.quantize_qwen3_weights(merged["params"])),
            True), (None, sd_merged, True)),
    }
    res = {}
    for mode in MODES:
        (lora, jdt, variables, fused), (plora, psd, int8) = setups[mode]
        t0 = time.perf_counter()
        want, jsubs = _jax_layers(jc, lora, jdt, variables, ids, mask, fused)
        tdt = torch.float32 if jdt == jnp.float32 else torch.bfloat16
        got, psubs = _port_layers(pc, plora, tdt, psd, ids, mask, fused, int8)
        forced = _port_layers(pc, plora, tdt, psd, ids, mask, fused, int8,
                              forced_inputs=want)[0]
        res[mode] = want, got
        print(f"{mode}: {time.perf_counter() - t0:.0f} s", flush=True)
        for name in sorted(set(jsubs) & set(psubs)) if args.probe else ():
            a, b = psubs[name], jsubs[name]
            if a.shape != b.shape:
                a = a.reshape(b.shape)
            print(f"  layer 0 {name}: max |port - JAX| "
                  f"{np.abs(a - b).max():.3e}, equal "
                  f"{(a == b).mean():.4f}", flush=True)
        for n in range(args.layers):
            free = _dist(got[n], want[n], rows)[0]
            fd, feq = _dist(forced[n], want[n], rows)
            line = (f"  layer {n:2d} free {free:.3e} forced {fd:.3e} "
                    f"(equal rows {feq:.3f})")
            if mode != "fp32":
                po = _dist(got[n], res["fp32"][1][n], rows)[0]
                jo = _dist(want[n], res["fp32"][0][n], rows)[0]
                line += (f" oracle port {po:.3e} JAX {jo:.3e} "
                         f"(port/JAX {po / jo:.3f})")
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
