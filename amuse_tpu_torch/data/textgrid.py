"""Praat TextGrid parsing: word/phone alignments for BEAT takes.

The port's copy of ``amuse_tpu/data/textgrid.py``.

The reference consumes per-take TextGrid files for semantic/word timing
(discovered in dm/dm.py path scanning; word tables in dm/utils/all_words.py,
corpus helpers in dm/utils/corpus_utils.py). This is a dependency-free
parser for the standard long TextGrid format -> interval tiers.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from pathlib import Path


@dataclass(frozen=True)
class Interval:
    xmin: float
    xmax: float
    text: str


@dataclass(frozen=True)
class Tier:
    name: str
    intervals: tuple[Interval, ...]

    def at(self, t: float) -> str:
        for iv in self.intervals:
            if iv.xmin <= t < iv.xmax:
                return iv.text
        return ""

    def words(self) -> list[Interval]:
        return [iv for iv in self.intervals if iv.text.strip()]


def parse_textgrid(path) -> dict[str, Tier]:
    """Long-format TextGrid -> {tier name: Tier}."""
    text = Path(path).read_text(errors="replace")
    tiers: dict[str, Tier] = {}
    # split into item blocks
    blocks = re.split(r"item\s*\[\d+\]:", text)[1:]
    for block in blocks:
        name_m = re.search(r'name\s*=\s*"([^"]*)"', block)
        if not name_m:
            continue
        name = name_m.group(1)
        ivs = []
        for m in re.finditer(
            r"intervals\s*\[\d+\]:\s*"
            r"xmin\s*=\s*([\d.eE+-]+)\s*"
            r"xmax\s*=\s*([\d.eE+-]+)\s*"
            r'text\s*=\s*"([^"]*)"',
            block,
        ):
            ivs.append(Interval(float(m.group(1)), float(m.group(2)), m.group(3)))
        tiers[name] = Tier(name, tuple(ivs))
    return tiers


def word_onsets(tiers: dict[str, Tier], tier_name: str = "words") -> list[float]:
    """Word onset times in seconds (for speech-gesture alignment metrics)."""
    tier = tiers.get(tier_name)
    if tier is None and tiers:
        tier = next(iter(tiers.values()))
    if tier is None:
        return []
    return [iv.xmin for iv in tier.words()]
