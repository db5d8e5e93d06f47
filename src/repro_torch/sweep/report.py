"""Markdown frontier table for ``$GITHUB_STEP_SUMMARY`` and local runs
(the port of the JAX package's ``sweep/report.py``: the same table for the
same rows).

The pivot view is the paper's Tables II–IV shape: one row per
(architecture, backend, grouping), one column per ``<E,M>`` format, so a
glance at the nightly job summary shows the accuracy/bit-width surface and
any newly diverged cell.
"""
from __future__ import annotations

from .grid import FORMATS

__all__ = ["frontier_table"]


def _fmt_metric(row: dict) -> str:
    if row["diverged"]:
        return "**DIVERGED**"
    if row["final_acc"] is not None:
        return f"acc {row['final_acc']:.3f}"
    if row["final_loss"] is not None:
        return f"loss {row['final_loss']:.3f}"
    return "n/a"


def frontier_table(rows: list[dict], title: str = "Bit-width × architecture frontier") -> str:
    """Render rows (runner output) as a markdown pivot + detail table."""
    fmts = [f for f in FORMATS if any(r["fmt"] == f for r in rows)]
    groups: dict[tuple[str, str, str], dict[str, dict]] = {}
    for r in rows:
        groups.setdefault((r["arch"], r["backend"], r["grouping"]), {})[r["fmt"]] = r

    lines = [f"### {title}", ""]
    lines.append("| arch | backend | " + " | ".join(f"`{f}`" for f in fmts) + " |")
    lines.append("|---|---|" + "---|" * len(fmts))
    for (arch, backend, grouping), by_fmt in groups.items():
        label = arch if grouping == "nc" else f"{arch} (grouping={grouping})"
        cells = [_fmt_metric(by_fmt[f]) if f in by_fmt else "—" for f in fmts]
        lines.append(f"| {label} | {backend} | " + " | ".join(cells) + " |")

    lines += ["", "<details><summary>per-cell detail</summary>", ""]
    lines.append("| cell | hash | loss | acc | steps | wall (s) |")
    lines.append("|---|---|---|---|---|---|")
    for r in rows:
        loss = "—" if r["final_loss"] is None else f"{r['final_loss']:.4f}"
        acc = "—" if r["final_acc"] is None else f"{r['final_acc']:.4f}"
        lines.append(
            f"| `{r['cell_id']}` | `{r['config_hash']}` | {loss} | {acc} "
            f"| {r['steps']} | {r['wall_time_s']:.1f} |")
    lines += ["", "</details>", ""]
    return "\n".join(lines)
