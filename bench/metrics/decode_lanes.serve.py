"""Decode lanes a window step carries: the engine ledger's
`decode_tokens` over its steps (speculation is off, so one token a
lane)."""


def read(run):
    rows = run.ledger
    if not rows:
        return None
    return sum(r["decode_tokens"] for r in rows) / len(rows)
