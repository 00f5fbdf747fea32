"""Small host utilities (a copy of the parts of ``sparse_caption_tpu/utils/misc.py`` the port uses)."""

from __future__ import annotations

import os


def csv_append_row(path: str, header: list, row: list) -> None:
    """Append one row to a CSV, writing the header when the file is new."""
    new = not os.path.isfile(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as f:
        if new:
            f.write(",".join(str(h) for h in header) + "\n")
        f.write(",".join(str(x) for x in row) + "\n")
