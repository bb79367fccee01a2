# Copied from cmtts_tpu/data/textgrid.py (jax-free) so that the port imports nothing of cmtts_tpu.
"""Minimal Praat TextGrid parser (the ``tgt`` package is unavailable).

Parses long- and short-format TextGrids produced by the Montreal Forced
Aligner; only interval tiers are needed (the reference reads the
"phones" tier, ``preprocessor/preprocessor.py:271-276``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass


@dataclass(frozen=True)
class Interval:
    start_time: float
    end_time: float
    text: str


@dataclass(frozen=True)
class IntervalTier:
    name: str
    intervals: list


def _unquote(s: str) -> str:
    s = s.strip()
    if len(s) >= 2 and s[0] == '"' and s[-1] == '"':
        s = s[1:-1]
    return s.replace('""', '"')


def read_textgrid(path: str) -> dict[str, IntervalTier]:
    """Returns {tier_name: IntervalTier}."""
    with open(path, encoding="utf-8") as f:
        content = f.read()
    if '"IntervalTier"' not in content:
        raise ValueError(f"no interval tiers in {path}")
    tiers: dict[str, IntervalTier] = {}
    # split on tier headers; robust to long ("item [n]:") and short formats
    chunks = re.split(r'"IntervalTier"', content)[1:]
    for chunk in chunks:
        # first quoted string after the class marker is the tier name
        m = re.search(r'"((?:[^"]|"")*)"', chunk)
        if not m:
            continue
        name = _unquote('"%s"' % m.group(1))
        intervals = []
        long_iv = re.findall(
            r"xmin\s*=\s*([\d.eE+-]+)\s*\n\s*xmax\s*=\s*([\d.eE+-]+)\s*\n\s*"
            r'text\s*=\s*"((?:[^"]|"")*)"',
            chunk)
        if long_iv:
            for s, e, t in long_iv:
                intervals.append(Interval(float(s), float(e), _unquote('"%s"' % t)))
        else:
            # short format: numbers and quoted texts interleaved after the
            # tier header (name, xmin, xmax, n, then triplets)
            tokens = re.findall(r'"(?:[^"]|"")*"|[\d.eE+-]+', chunk)
            # tokens[0]=name, 1=xmin, 2=xmax, 3=count, then (s, e, "text")*
            body = tokens[4:]
            for i in range(0, len(body) - 2, 3):
                s, e, t = body[i], body[i + 1], body[i + 2]
                if not t.startswith('"'):
                    break
                intervals.append(Interval(float(s), float(e), _unquote(t)))
        tiers[name] = IntervalTier(name, intervals)
    return tiers
