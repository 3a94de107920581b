"""Throughput meters, progress files, a device self-test, ``torch.profiler``
traces, named spans and per-card memory statistics (port of
``unirec_tpu/utils/profiling.py``).

``ThroughputMeter`` and ``ProgressWriter`` carry the reference's ``--profile``
statistics and resumable progress JSON
(reference: data_processing/generate_all_item_embeddings.py:221-316).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """``torch.profiler`` over the block (CPU, plus CUDA where a card is
    present), written to ``log_dir/trace.json`` for Perfetto or
    chrome://tracing; yields the profiler (None when ``log_dir`` is None)."""
    if not log_dir:
        yield None
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """A named span in a ``torch.profiler`` trace for a host-side phase
    (``torch.profiler.record_function``; a context manager)."""
    return torch.profiler.record_function(name)


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Per-card memory: ``{"cuda:i": {"bytes_in_use", "bytes_limit",
    "peak_bytes_in_use"}}`` from ``torch.cuda.memory_stats`` and the card's
    total memory; empty without a card."""
    out: Dict[str, Dict[str, int]] = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(i).total_memory),
            "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0)),
        }
    return out


@dataclass
class ThroughputMeter:
    """Per-batch timing with items/sec, ETA and variance stats.  A batch's
    time is whatever ``end_batch`` closes: the caller makes it end in a copy
    to the host when device time is to count."""

    total_items: int = 0
    batch_times: List[float] = field(default_factory=list)
    batch_sizes: List[int] = field(default_factory=list)
    _t0: float = 0.0

    def start_batch(self) -> None:
        self._t0 = time.perf_counter()

    def end_batch(self, n_items: int) -> float:
        dt = time.perf_counter() - self._t0
        self.batch_times.append(dt)
        self.batch_sizes.append(n_items)
        return dt

    @property
    def items_done(self) -> int:
        return int(sum(self.batch_sizes))

    @property
    def items_per_sec(self) -> float:
        t = sum(self.batch_times)
        return self.items_done / t if t > 0 else 0.0

    def eta_seconds(self) -> float:
        if not self.batch_times or self.total_items <= 0:
            return 0.0
        remaining = max(self.total_items - self.items_done, 0)
        return remaining / max(self.items_per_sec, 1e-9)

    def stats(self) -> Dict[str, float]:
        times = np.asarray(self.batch_times) if self.batch_times else np.zeros(1)
        return {
            "items_done": self.items_done,
            "items_per_sec": round(self.items_per_sec, 2),
            "mean_batch_time_s": round(float(times.mean()), 4),
            "batch_time_std_s": round(float(times.std()), 4),
            "eta_s": round(self.eta_seconds(), 1),
        }


def check_devices(verbose: bool = True) -> Dict[str, object]:
    """Device self-test (the reference's --check-gpu probe,
    generate_all_item_embeddings.py:52-120): list the CUDA devices and run
    one matmul on the first; ``ok`` is False without a card."""
    info: Dict[str, object] = {
        "cuda": torch.cuda.is_available(),
        "device_count": torch.cuda.device_count(),
        "devices": [torch.cuda.get_device_name(i)
                    for i in range(torch.cuda.device_count())],
    }
    if info["cuda"]:
        x = torch.ones(128, 128, device="cuda")
        info["probe_matmul"] = float((x @ x).sum())
        info["ok"] = info["probe_matmul"] == 128.0 ** 3
    else:
        info["ok"] = False
        info["error"] = "no CUDA device"
    if verbose:
        print(json.dumps(info, indent=2))
    return info


class ProgressWriter:
    """Periodic progress JSON enabling manual resume
    (reference: generate_all_item_embeddings.py:311-316)."""

    def __init__(self, path: Optional[str], every_batches: int = 5):
        self.path = path
        self.every = every_batches
        self._count = 0

    def update(self, payload: Dict) -> None:
        self._count += 1
        if self.path and self._count % self.every == 0:
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, self.path)

    def finish(self, payload: Dict) -> None:
        if self.path:
            with open(self.path, "w") as f:
                json.dump(payload, f)
