"""Render dry-run rows (``launch/dryrun.py --out``) as a Markdown table.

    PYTHONPATH=src python -m repro_torch.launch.report rows.json [--plain]

A term the port does not count (None: the temporary bytes) prints
``-``; the collective time is ``coll_bytes`` over the NVLink rate
(``launch/roofline.py``).
"""

from __future__ import annotations

import json
import sys


def fmt_bytes(b):
    if b is None:
        return "-"
    return f"{b / 2**30:.2f}"


def fmt_ms(s):
    if s is None:
        return "-"
    return f"{s * 1e3:.2f}"


def render(rows: list[dict], with_roofline: bool = True) -> str:
    out = []
    if with_roofline:
        out.append("| arch | shape | t_comp (ms) | t_mem (ms) | t_coll (ms) "
                   "| bound | useful | temp/dev (GiB) |")
        out.append("|---|---|---:|---:|---:|---|---:|---:|")
    else:
        out.append("| arch | shape | mesh | status | temp/dev (GiB) |")
        out.append("|---|---|---|---|---:|")
    for r in rows:
        if not r.get("ok"):
            out.append(f"| {r['arch']} | {r['shape']} | {r.get('mesh','?')} | "
                       f"FAIL: {r.get('error','')[:60]} | - |")
            continue
        if with_roofline:
            out.append(
                f"| {r['arch']} | {r['shape']} | {fmt_ms(r['t_compute_s'])} | "
                f"{fmt_ms(r['t_memory_s'])} | {fmt_ms(r['t_collective_s'])} | "
                f"{r['dominant']} | {r['useful_ratio']:.2f} | "
                f"{fmt_bytes(r.get('temp_bytes'))} |")
        else:
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | OK | "
                       f"{fmt_bytes(r.get('temp_bytes'))} |")
    return "\n".join(out)


def main():
    path = sys.argv[1]
    with_roofline = "--plain" not in sys.argv
    with open(path) as f:
        rows = json.load(f)
    print(render(rows, with_roofline))


if __name__ == "__main__":
    main()
