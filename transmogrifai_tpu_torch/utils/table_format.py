"""ASCII table renderer (counterpart of
``transmogrifai_tpu.utils.table_format``), used by the model insights'
``pretty_print``."""
from __future__ import annotations

from typing import Any, List, Optional, Sequence


def format_table(columns: Sequence[str], rows: Sequence[Sequence[Any]],
                 title: Optional[str] = None,
                 max_cell_width: int = 40) -> str:
    """Render rows as a boxed ASCII table.

    >>> print(format_table(["a", "b"], [[1, "x"]]))
    +---+---+
    | a | b |
    +---+---+
    | 1 | x |
    +---+---+
    """
    def cell(v: Any) -> str:
        s = "" if v is None else (f"{v:.6g}" if isinstance(v, float) else str(v))
        return s if len(s) <= max_cell_width else s[:max_cell_width - 1] + "…"

    head = [cell(c) for c in columns]
    body = [[cell(v) for v in row] for row in rows]
    ncol = max([len(head)] + [len(r) for r in body]) if (head or body) else 0
    head += [""] * (ncol - len(head))
    body = [r + [""] * (ncol - len(r)) for r in body]
    widths = [max([len(head[i])] + [len(r[i]) for r in body] + [1])
              for i in range(ncol)]
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"

    def line(cells: List[str], right_align: bool = False) -> str:
        parts = []
        for v, w in zip(cells, widths):
            parts.append(f" {v:>{w}} " if right_align and _num(v)
                         else f" {v:<{w}} ")
        return "|" + "|".join(parts) + "|"

    def _num(s: str) -> bool:
        try:
            float(s)
            return True
        except ValueError:
            return False

    out = []
    if title:
        width = len(sep)
        out.append(title.center(width).rstrip())
    out += [sep, line(head), sep]
    out += [line(r, right_align=True) for r in body]
    out.append(sep)
    return "\n".join(out)
