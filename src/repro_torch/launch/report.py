"""The roofline table from dry-run JSON results (the port's copy of
`repro.launch.report`), on H100 spec constants (`launch.roofline`), and a
card's memory by cell.

  PYTHONPATH=src python -m repro_torch.launch.report results/dryrun.json
"""
from __future__ import annotations

import json
import sys

from repro_torch.configs.base import SHAPES
from repro_torch.launch.roofline import (HBM_BW, HBM_BYTES, NET_BW,
                                         PEAK_FLOPS, mesh_chips, model_flops)
from repro_torch.models import registry


def rows_from(path: str) -> list[dict]:
    with open(path) as f:
        records = json.load(f)
    out = []
    for rec in records:
        if not rec["ok"]:
            out.append({"arch": rec["arch"], "shape": rec["shape"],
                        "mesh": rec["mesh"], "error": rec.get("error")})
            continue
        cfg = registry.get_config(rec["arch"])
        shape = SHAPES[rec["shape"]]
        chips = mesh_chips(rec["mesh"])
        fl = rec.get("flops_per_device_loop_aware") or rec["flops_per_device"]
        by_lo = rec["bytes_per_device"]
        # memory term: matmul-operand traffic (loop-aware); falls back to the
        # all-op-output estimate for older records
        by_hi = rec.get("dot_bytes_per_device_loop_aware") or rec.get(
            "bytes_per_device_loop_aware", by_lo)
        co = rec.get("collective_bytes_per_device_loop_aware",
                     rec["collective_bytes_per_device"])
        compute_s = fl / PEAK_FLOPS
        mem_lo_s = by_lo / HBM_BW
        mem_hi_s = by_hi / HBM_BW
        coll_s = co / NET_BW
        mf = model_flops(cfg, shape)
        terms = {"compute": compute_s, "memory": mem_hi_s, "collective": coll_s}
        bottleneck = max(terms, key=terms.get)
        step = max(terms.values())
        out.append({
            "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
            "chips": chips,
            "compute_s": compute_s, "memory_lo_s": mem_lo_s,
            "memory_hi_s": mem_hi_s, "collective_s": coll_s,
            "bottleneck": bottleneck,
            "model_flops": mf,
            "hlo_flops_global": fl * chips,
            "useful_frac": mf / (fl * chips) if fl else 0.0,
            "roofline_frac": compute_s / step if step else 0.0,
            "hbm_gib": (rec["argument_bytes"] + rec["temp_bytes"]
                        + rec["output_bytes"] - rec["alias_bytes"]) / 2**30,
            "stream_mode": rec.get("stream_mode", "resident"),
        })
    return out


def markdown_table(rows: list[dict]) -> str:
    hdr = ("| arch | shape | mesh | compute s | memory s (lo–hi) | collective s "
           "| bottleneck | MODEL/HLO flops | roofline frac |\n"
           "|---|---|---|---|---|---|---|---|---|\n")
    lines = []
    for r in rows:
        if "error" in r and r.get("error"):
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | — | — "
                         f"| FAILED | — | — |")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['compute_s']:.4f} "
            f"| {r['memory_lo_s']:.4f}–{r['memory_hi_s']:.4f} "
            f"| {r['collective_s']:.4f} "
            f"| {r['bottleneck']} "
            f"| {r['useful_frac']:.2f} "
            f"| {r['roofline_frac']:.2f} |")
    return hdr + "\n".join(lines)


def sizing_table(path: str) -> str:
    """A card's share of each cell: its parameters, its peak (arguments +
    temp + output - alias), whether that fits `HBM_BYTES`, and the
    seconds the dry run took to count it (a failed cell: its error)."""
    with open(path) as f:
        records = json.load(f)
    lines = ["| arch | shape | mesh | params GiB | peak GiB | fits "
             "| count s |", "|---|---|---|---|---|---|---|"]
    for r in records:
        head = f"| {r['arch']} | {r['shape']} | {r['mesh']} "
        if not r["ok"]:
            lines.append(head + f"| — | — | FAILED: {r.get('error')} "
                         f"| {r.get('count_s', 0):.1f} |")
            continue
        lines.append(head + f"| {r['param_bytes'] / 2**30:.2f} "
                     f"| {r['hbm_bytes'] / 2**30:.2f} "
                     f"| {'yes' if r['fits'] else 'no'} "
                     f"| {r['count_s']:.1f} |")
    return "\n".join(lines)


def main(argv=None):
    paths = (argv or sys.argv[1:]) or ["results/dryrun.json"]
    for p in paths:
        rows = rows_from(p)
        print(f"\n### {p} (H100 SXM5 spec constants, not measured)\n")
        print(markdown_table(rows))
        print(f"\nA card's memory against {HBM_BYTES:,} bytes:\n")
        print(sizing_table(p))


if __name__ == "__main__":
    main()
