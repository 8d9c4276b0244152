"""What the metric readers (``metrics/<name>.py``) share.

A reader is ``read(run, name) -> float | None``, where ``run`` is
``bench.Run``. A split metric ``<family>.<kind>`` reads only in cells whose
traffic kind is ``<kind>`` (``backlog`` or ``open``); a reader that finds
nothing to read returns None and the metric is left out of the line.
"""
from __future__ import annotations

from typing import Optional


def kind_of(name: str) -> Optional[str]:
    return name.split(".", 1)[1] if "." in name else None


def applies(run, name: str) -> bool:
    kind = kind_of(name)
    return kind is None or kind == run.kind


def share(num: float, den: float) -> Optional[float]:
    """100 * num / den, or None where there is nothing to divide by."""
    if not den or den <= 0:
        return None
    return 100.0 * num / den
