"""Median wait of a window request in the serving engine's queue: from its
``submit`` to its ``dispatch`` event (``obs/trace.py``, on the engine's
clock), in ms.  Moves ``p95_ms``."""
import numpy as np


def read(run):
    events = getattr(run.driver, "events", None)
    if not events:
        return None
    want = set(run.readings["rids"])
    submit = {e.rid: e.ts for e in events if e.kind == "submit"
              and e.rid in want}
    waits = [e.ts - submit[rid] for e in events if e.kind == "dispatch"
             for rid in e.get("rids", ()) if rid in submit]
    return float(np.median(waits)) * 1e3 if waits else None
