# Copied from cmtts_tpu/text/__init__.py (jax-free) so that the port imports nothing of cmtts_tpu.
"""Text front-end: grapheme/phoneme strings -> symbol ID sequences.

Behavior-compatible with the reference pipeline (``text/__init__.py:15-57``):
text may embed ARPAbet (or pinyin) runs in curly braces, e.g.
``"Turn left on {HH AW1 S S T AH0 N} Street."``; brace contents map to
``@``-prefixed phoneme symbols, everything else is cleaned then mapped
character-by-character.
"""

from __future__ import annotations

import re
from typing import Iterable

from cmtts_tpu_torch.text.cleaners import CLEANERS
from cmtts_tpu_torch.text.symbols import PAD, symbol_to_id, id_to_symbol, symbols, _silences

_curly_re = re.compile(r"(.*?)\{(.+?)\}(.*)")


def _clean_text(text: str, cleaner_names: Iterable[str]) -> str:
    for name in cleaner_names:
        cleaner = CLEANERS.get(name)
        if cleaner is None:
            raise ValueError(f"Unknown cleaner: {name}")
        text = cleaner(text)
    return text


def _keep(symbol: str) -> bool:
    return symbol in symbol_to_id and symbol not in (PAD, "~")


def _symbols_to_sequence(chars: Iterable[str]) -> list[int]:
    return [symbol_to_id[s] for s in chars if _keep(s)]


def _phonemes_to_sequence(phonemes: str) -> list[int]:
    return _symbols_to_sequence("@" + p for p in phonemes.split())


def text_to_sequence(text: str, cleaner_names: Iterable[str]) -> list[int]:
    """Convert text (with optional {ARPAbet} runs) to symbol IDs."""
    sequence: list[int] = []
    while text:
        m = _curly_re.match(text)
        if not m:
            sequence += _symbols_to_sequence(_clean_text(text, cleaner_names))
            break
        sequence += _symbols_to_sequence(_clean_text(m.group(1), cleaner_names))
        sequence += _phonemes_to_sequence(m.group(2))
        text = m.group(3)
    return sequence


def sequence_to_text(sequence: Iterable[int]) -> str:
    out = []
    for sid in sequence:
        s = id_to_symbol.get(int(sid))
        if s is None:
            continue
        if len(s) > 1 and s.startswith("@"):
            s = "{%s}" % s[1:]
        out.append(s)
    return "".join(out).replace("}{", " ")


def sil_phonemes_ids() -> list[int]:
    """IDs of silence phonemes (used by the word/sentence duration loss,
    reference ``model/loss.py:263-266``)."""
    return [symbol_to_id[s] for s in _silences]
