"""Where the time of K1 and B7b's dq and dk / dv goes at a head dim that
the chunked form zero-pads (320, run as two chunks of 256) against one it
takes as it is (512), on one card.

    python3 scripts/profile_padded_launch.py [--iters 20]

At chip_smoke.py's WIDE_CAUSAL shape (B 2, L 512, 4 query / 2 key heads,
rows of 512 and 301 keys, bf16), in turns 512, 320, 512, 320, each wrapper
is timed three ways: CUDA events over ``--iters`` calls after 3 warm-ups
(what chip_smoke.py reports), the host's enqueue time of the same calls
(no synchronisation inside the loop), and one ``torch.profiler`` window of
``--iters`` calls, which gives the device time of each kernel a call (the
chunked kernel, the padding's copies, the rest) and the wall time a call.
Where the events' time a call exceeds the device time a call, the card
waits on the host.  Prints the card's name and power limit, a table a
case, and one JSON line a case.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

B, L, HQ, HKV, LENGTHS = 2, 512, 4, 2, (512, 301)


def _events_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _host_ms(fn, iters: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / iters


def _profile(fn, iters: int):
    """(device ms a call by kernel, device ms a call, wall ms a call)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / iters
    rows = {}
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0)
        if t > 0:
            rows[ev.key] = t / 1e3 / iters
    return rows, sum(rows.values()), wall


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_padded_launch: no CUDA device", file=sys.stderr)
        return 2
    from unirec_tpu_torch.ops import flash_causal as fc

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    mask = (torch.arange(L, device="cuda")[None]
            < torch.as_tensor(LENGTHS, device="cuda")[:, None]).float()
    cases = {}
    for hd in (512, 320):
        gen = torch.Generator(device="cuda").manual_seed(hd)
        q, k, v, do = (torch.randn(B, L, h * hd, device="cuda", generator=gen)
                       .bfloat16() for h in (HQ, HKV, HKV, HQ))
        o, m, den = fc._k1(q, k, v, mask, HQ, HKV, stats=True)
        dsum = fc.attention_dsum(do, o, HQ).contiguous()
        args_b = (q, k, v, mask, do, m, den, dsum, HQ, HKV)
        cases[hd] = {
            "k1": lambda q=q, k=k, v=v: fc.flash_causal_attention(
                q, k, v, mask, HQ, HKV, mask_checked=True),
            "dq": lambda a=args_b: fc.flash_causal_bwd_dq(*a),
            "dkv": lambda a=args_b: fc.flash_causal_bwd_dkv(*a)}
    for turn, hd in enumerate((512, 320, 512, 320)):
        for name, fn in cases[hd].items():
            events = _events_ms(fn, args.iters)
            host = _host_ms(fn, args.iters)
            rows, device, wall = _profile(fn, args.iters)
            print(f"\n[{smi}] turn {turn} hd {hd} {name}: events "
                  f"{events:.4f} ms a call, host enqueue {host:.4f} ms, "
                  f"device {device:.4f} ms, wall under the profiler "
                  f"{wall:.4f} ms", flush=True)
            for key, t in sorted(rows.items(), key=lambda r: -r[1]):
                print(f"  {t:9.4f} ms  {key[:100]}")
            print(json.dumps({"turn": turn, "hd": hd, "kernel": name,
                              "events_ms": events, "host_ms": host,
                              "device_ms": device, "wall_ms": wall,
                              "by_kernel": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
