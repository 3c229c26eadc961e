"""The CLI process's seconds blocked on the prep pool's results
(``ApplyResult.get``), as a share of the window."""

UNIT = "%"


def read(rec):
    passes = rec.get("passes", [])
    if not passes or "span_s" not in passes[0]:
        return None
    wait = sum(p["span_s"].get("prep_wait", 0.0) for p in passes)
    return 100.0 * wait / rec["window_s"]
