"""Terminal progress bar and a minimal ASCII table (no external deps)."""
from __future__ import annotations

from typing import List, Sequence


class ProgressBar:
    def __init__(self, length: int, max_val: int):
        self.length = length
        self.max_val = max(max_val, 1)

    def get_bar(self, val: int) -> str:
        val = min(val, self.max_val)
        n = int(self.length * val / self.max_val)
        return '█' * n + '░' * (self.length - n)


def ascii_table(rows: Sequence[Sequence]) -> str:
    cells = [[str(c) for c in r] for r in rows]
    widths = [max(len(r[i]) for r in cells) for i in range(len(cells[0]))]
    sep = '+' + '+'.join('-' * (w + 2) for w in widths) + '+'
    out: List[str] = [sep]
    for i, r in enumerate(cells):
        out.append('| ' + ' | '.join(c.ljust(w) for c, w in zip(r, widths)) + ' |')
        if i == 0:
            out.append(sep)
    out.append(sep)
    return '\n'.join(out)
