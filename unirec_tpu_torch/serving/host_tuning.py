"""Host-heap GC tuning for the serving hot loop (the port's copy of
``unirec_tpu/serving/host_tuning.py``).

The serving host state is large and permanently live: the catalog dict
(20k+ items), the field-embedding cache and the prompt fragment cache.
CPython's generational GC rescans all of it on every gen-2 collection, which
shows up as periodic multi-ms stalls in a sustained serving loop.

``freeze_host_heap()`` applies the standard production remedy: one full
collection, then ``gc.freeze()`` moves every surviving object into the
permanent generation, which no future collection traverses.  Per-request
garbage stays in gen 0/1 where collections only walk the (small) young
heap.  Call it AFTER warmup: anything allocated later is unfrozen and
collected normally.

This is an explicit entry-point-level call (server startup, bench
harness), never an import side effect: freezing is process-global and the
caller owns that decision.
"""

from __future__ import annotations

import gc


def freeze_host_heap() -> int:
    """Collect, then freeze the live heap out of future GC scans.

    Returns the number of objects moved to the permanent generation.
    Idempotent: refreezing adds only objects allocated since the last
    freeze.  ``gc.unfreeze()`` undoes it (tests).
    """
    gc.collect()
    gc.freeze()
    return gc.get_freeze_count()
