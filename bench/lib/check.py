"""How `correct` is decided: the plain reference judges what the timed path
produced.

Serving: once the window has closed and the program's pools are freed, a
sample of the requests the window finished (drawn from the seed, the one
with the most served tokens always in it) is run through the reference
once, each prompt with its served tokens.  At every served token the gap
by which the reference's logit of that token lies below the reference's
best is read; the widest gap over the sample is the number compared with
the cell's limit.  Greedy decoding serves the token its own logits put
first, so a sound program reads a gap only where the reference's top two
lie closer than the program's rounding.

The control (`readings(..., control=True)`): the reference computed with
every weight product in float8 e4m3, at the same positions; its number is
the widest gap of the token it puts first.
"""
from __future__ import annotations

import numpy as np
import torch

from bench.reference import model as ref


def sample_finished(run, seed: int, n: int, min_tokens: int = 0) -> list:
    """Requests the window finished: the one with the most served tokens,
    then others in an order drawn from the seed, until there are n of them
    and min_tokens served tokens (or none is left)."""
    done = [r for r in run.requests
            if r.done_t is not None and run.t0 < r.done_t <= run.t_end]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.req.produced), -r.index))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng((int(seed), 0x5EED))
    out = [longest]
    tokens = len(longest.req.produced)
    for i in rng.permutation(len(rest)):
        if len(out) >= n and tokens >= min_tokens:
            break
        out.append(rest[i])
        tokens += len(rest[i].req.produced)
    return out


def _stats(gap: torch.Tensor, prefix: str = "") -> dict:
    """The widest gap, the mean gap and the share of tokens that are not
    the reference's first choice (gap above 0)."""
    return {prefix + "logit_gap": float(gap.max()),
            prefix + "mean_logit_gap": float(gap.mean()),
            prefix + "p99_logit_gap": float(torch.quantile(gap, 0.99)),
            prefix + "not_first_share": float((gap > 0).float().mean())}


def readings(pub: dict, params: dict, samples, device,
             control: bool = False) -> dict:
    """Statistics of the served tokens' gaps below the reference's best
    (and, with `control`, of the fp8 reference's first choices), plus the
    count of tokens read."""
    seqs, rows, served = [], [], []
    for prompt, produced in samples:
        toks = np.concatenate([np.asarray(prompt, np.int64),
                               np.asarray(produced[:-1], np.int64)])
        p = len(prompt)
        seqs.append(torch.as_tensor(toks, device=device))
        rows.append(torch.arange(p - 1, p - 1 + len(produced),
                                 device=device))
        served.append(torch.as_tensor(np.asarray(produced, np.int64),
                                      device=device))
    logits = ref.logits_at(pub, params, seqs, rows)
    best = [lg.max(dim=-1).values for lg in logits]
    gap = torch.cat([b - lg.gather(1, s[:, None])[:, 0]
                     for b, lg, s in zip(best, logits, served)])
    out = _stats(gap)
    out["tokens"] = int(gap.numel())
    if control:
        low = ref.logits_at(pub, params, seqs, rows, quant="fp8")
        cgap = torch.cat([b - lg.gather(1, c.argmax(dim=-1)[:, None])[:, 0]
                          for b, lg, c in zip(best, logits, low)])
        out.update(_stats(cgap, "control_"))
    return out


def judge_serve(cell: dict, pub: dict, params: dict, run, seed: int,
                device) -> dict:
    """{"correct", "numbers": {name: {"value", "limit"}}, "readings"} of a
    run: each number the cell's check limits, and tokens_checked."""
    chk = cell["check"]
    picked = sample_finished(run, seed, int(chk["requests"]),
                             int(chk["min_tokens"]))
    if not picked:
        return {"correct": False, "readings": {}, "numbers": {
            "finished_in_window": {"value": 0, "limit": 1}}}
    r = readings(pub, params, [(t.prompt, t.tokens) for t in picked],
                 device)
    nums = {k: {"value": r[k], "limit": float(v)}
            for k, v in chk["limits"].items()}
    nums["tokens_checked"] = {"value": r["tokens"],
                              "limit": int(chk["min_tokens"])}
    ok = all(r[k] <= float(v) for k, v in chk["limits"].items()) \
        and r["tokens"] >= int(chk["min_tokens"])
    return {"correct": bool(ok), "numbers": nums, "readings": r}
