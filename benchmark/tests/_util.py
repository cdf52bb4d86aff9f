"""Helpers of the benchmark's tests: the repository on the path, and a cell
shrunk to a size the CPU runs in seconds."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.core import cell as cells  # noqa: E402


def small_cell(name: str, img_size: int = 64, batch: int = 2, dtype: str = 'float32'):
    cell = cells.load_cell(name)
    cell.overrides = dict(img_size=img_size, batch=batch, compute_dtype=dtype)
    return cell
