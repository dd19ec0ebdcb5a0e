"""The engine's request-level balance ratio (the paper's), averaged over
its multi-lane admission rounds (``serving/metrics.py``'s
``request_balance``).  Moves ``p95_ms``."""


def read(run):
    s = getattr(run.driver, "summary", None)
    if not s or not s.get("balance_rounds"):
        return None
    return float(s["request_balance"])
