"""Minimal Praat TextGrid reader (long + short format intervals).

The port's own copy of ``tpu_speech/data/textgrid.py``: a native
replacement for the ``tgt`` dependency used by DiffVC's data filtering and
average-mel builder (DiffVC/data.py:37-50, get_avg_mels.ipynb); it only needs
interval tiers with (start, end, text).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List


@dataclass
class Interval:
    start_time: float
    end_time: float
    text: str


def read_textgrid(path: str) -> Dict[str, List[Interval]]:
    """Parse a TextGrid file -> {tier_name: [Interval, ...]}."""
    with open(path, encoding="utf-8", errors="replace") as f:
        content = f.read()

    tiers: Dict[str, List[Interval]] = {}
    # long-format: item [n]: ... name = "phones" ... intervals [k]: xmin/xmax/text
    tier_chunks = re.split(r"item\s*\[\d+\]\s*:", content)[1:]
    for chunk in tier_chunks:
        name_m = re.search(r'name\s*=\s*"([^"]*)"', chunk)
        if not name_m:
            continue
        name = name_m.group(1)
        intervals = []
        for m in re.finditer(
            r"intervals\s*\[\d+\]\s*:?\s*"
            r"xmin\s*=\s*([\d.eE+-]+)\s*"
            r"xmax\s*=\s*([\d.eE+-]+)\s*"
            r'text\s*=\s*"([^"]*)"',
            chunk,
        ):
            intervals.append(
                Interval(float(m.group(1)), float(m.group(2)), m.group(3))
            )
        tiers[name] = intervals
    return tiers


def get_tier(path: str, tier_name: str = "phones") -> List[Interval]:
    tiers = read_textgrid(path)
    if tier_name not in tiers:
        raise KeyError(f"tier '{tier_name}' not in {path} (has {list(tiers)})")
    return tiers[tier_name]


def has_phone(path: str, phone: str = "spn", tier_name: str = "phones") -> bool:
    try:
        return any(iv.text == phone for iv in get_tier(path, tier_name))
    except (KeyError, OSError):
        return False
