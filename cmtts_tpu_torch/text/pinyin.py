# Copied from cmtts_tpu/text/pinyin.py (jax-free).
"""Mandarin pinyin frontend: toned-syllable -> phoneme decomposition.

The reference ships ``text/pinyin.py`` (symbol lists only) plus a
4120-line data file ``lexicon/pinyin-lexicon-r.txt`` mapping every toned
pinyin syllable to initial+final phones (with er-hua ``rr``); its zh CLI
path raises NotImplemented.  Here the decomposition is computed by rule
(standard pinyin orthography -> initial/final analysis, including the
lexicon's conventions: y/w medial expansion, ``weng -> uen``, apical
vowels ``ii``/``iii``, the ü/v series, er-hua suffixing), validated
golden against the reference data file entry-by-entry — no vendored
asset needed.

Output phones are the ``@``-prefixed pinyin symbols already declared in
``cmtts_tpu_torch/text/symbols.py``, so ``text_to_sequence("{n i3 h ao3}")``
round-trips.
"""

from __future__ import annotations

import re

from cmtts_tpu_torch.text.symbols import _PINYIN_FINALS, _PINYIN_INITIALS

_INITIALS = sorted(_PINYIN_INITIALS, key=len, reverse=True)  # zh/ch/sh first
_FINAL_SET = set(_PINYIN_FINALS)

# standalone syllables that are pure finals (no initial phone)
_BARE_FINALS = {"a", "ai", "an", "ang", "ao", "e", "ei", "en", "eng",
                "er", "o", "ou"}

# y-initial orthography -> final (the lexicon keeps the y as an initial
# phone and expands the medial)
_Y_FINALS = {
    "i": "i", "in": "in", "ing": "ing",
    "a": "ia", "an": "ian", "ang": "iang", "ao": "iao",
    "e": "ie", "o": "iou", "ou": "iou", "ong": "iong",
    "u": "v", "ue": "ve", "uan": "van", "un": "vn",
}

# w-initial orthography -> final
_W_FINALS = {
    "u": "u", "a": "ua", "ai": "uai", "an": "uan", "ang": "uang",
    "ei": "uei", "en": "uen", "eng": "uen",  # lexicon quirk: weng -> uen
    "o": "uo",
}


def _decompose_base(base: str) -> list[str] | None:
    """Toneless orthographic syllable -> [initial?, final] (no tone)."""
    if base in ("er", "r"):
        return ["er"]
    if base in _BARE_FINALS:
        return [base]

    for ini in _INITIALS:
        if base.startswith(ini) and len(base) > len(ini):
            rest = base[len(ini):]
            break
    else:
        return None

    if ini == "y":
        fin = _Y_FINALS.get(rest)
        return ["y", fin] if fin else None
    if ini == "w":
        fin = _W_FINALS.get(rest)
        return ["w", fin] if fin else None

    # apical vowels: zi/ci/si -> ii, zhi/chi/shi/ri -> iii
    if rest == "i":
        if ini in ("z", "c", "s"):
            return [ini, "ii"]
        if ini in ("zh", "ch", "sh", "r"):
            return [ini, "iii"]
        return [ini, "i"]

    # ü series: explicit v spelling, or u after j/q/x
    if rest.startswith("v"):
        fin = {"v": "v", "ve": "ve", "van": "van", "vn": "vn"}.get(rest)
        return [ini, fin] if fin else None
    if ini in ("j", "q", "x"):
        rest = {"u": "v", "ue": "ve", "uan": "van", "un": "vn",
                "iu": "iou"}.get(rest, rest)
    else:
        # orthographic contractions after ordinary initials
        rest = {"iu": "iou", "ui": "uei", "un": "uen", "ue": "ve"}.get(rest, rest)

    if rest == "er":
        # initial+er is only reachable as er-hua of initial+e
        # (lexicon: "cer1 -> c e1 rr"); the caller's er-hua fallback
        # handles it
        return None
    return [ini, rest] if rest in _FINAL_SET else None


def syllable_to_phones(syllable: str) -> list[str] | None:
    """Toned pinyin syllable (e.g. ``"zhuang1"``, ``"lüe4"``/``"lve4"``,
    er-hua ``"huar2"``) -> phone list (e.g. ``["zh", "uang1"]``), or
    None if it is not valid pinyin."""
    syl = syllable.lower().strip().replace("ü", "v")
    m = re.fullmatch(r"([a-zv]+)([1-5])", syl)
    if not m:
        return None
    base, tone = m.group(1), m.group(2)

    out = _decompose_base(base)
    if out is None and base.endswith("r") and len(base) > 1:
        out = _decompose_base(base[:-1])  # er-hua: huar -> hua + rr
        if out is not None:
            out = out[:-1] + [out[-1] + tone, "rr"]
            return out
    if out is None:
        return None
    return out[:-1] + [out[-1] + tone]


def read_pinyin_lexicon(path: str) -> dict[str, list[str]]:
    """Parse a reference-format pinyin lexicon (first entry wins,
    matching the reference's ``read_lexicon``, synthesize.py:155-166)."""
    lex: dict[str, list[str]] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                lex.setdefault(parts[0], parts[1:])
    return lex


def preprocess_mandarin(text: str, lexicon_path: str | None = None) -> str:
    """Space-separated toned-pinyin text -> ``{phones}`` string (the zh
    counterpart of ``preprocess_english``; the reference CLI raises for
    zh — this implements the path its data supports).  If ``pypinyin``
    is installed, raw hanzi is transliterated first.  Unknown tokens
    become ``sp``."""
    lexicon = read_pinyin_lexicon(lexicon_path) if lexicon_path else None
    try:
        from pypinyin import Style, pinyin  # optional, not in this env

        if re.search(r"[一-鿿]", text):
            text = " ".join(
                p[0] for p in pinyin(text, style=Style.TONE3, neutral_tone_with_five=True))
    except ImportError:
        pass

    phones: list[str] = []
    for tok in re.split(r"\s+", text.strip()):
        if not tok:
            continue
        tok = tok.strip(",.!?;:\"'")
        if not tok:
            phones.append("sp")
            continue
        ph = (lexicon.get(tok.lower()) if lexicon else None) \
            or syllable_to_phones(tok)
        phones.extend(ph if ph else ["sp"])
    return "{" + " ".join(phones) + "}"
