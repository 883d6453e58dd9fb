"""Share (%) of the paged pool's blocks in use, the engine ledger's
`blocks_in_use` over the pool's blocks (the null block left out), mean
over the window's steps."""


def read(run):
    rows = run.ledger
    if not rows or run.num_blocks <= 1:
        return None
    used = sum(r["blocks_in_use"] for r in rows) / len(rows)
    return 100.0 * used / (run.num_blocks - 1)
