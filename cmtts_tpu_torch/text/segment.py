# Copied from cmtts_tpu/text/segment.py (jax-free) so that the port imports nothing of cmtts_tpu.
"""Long-form text segmentation for chunked synthesis.

The model caps one utterance at ``model.max_seq_len`` mel frames
(~11.6 s at 22.05 kHz / 256 hop) — the reference silently truncates
anything longer (its length regulator clamps to max_seq_len,
``utils/tools.py:304``; no long-form path exists). Here long input is
split into sentences, sentences are greedily packed into chunks that
fit the frame budget, and all chunks synthesize as ONE batched call
(see ``cmtts_tpu_torch.pipeline.synthesize_long``).
"""

from __future__ import annotations

import re
from typing import Callable, Sequence

import numpy as np

# common abbreviations that end with '.' but don't end a sentence
_ABBREV = {"mr", "mrs", "ms", "dr", "prof", "sr", "jr", "st", "vs", "etc",
           "e.g", "i.e", "fig", "no", "inc", "ltd", "co"}

_SENT_BOUNDARY = re.compile(r"(?<=[.!?;:])\s+|(?<=[。！？；])\s*")


def sentences(text: str) -> list[str]:
    """Split text at sentence-final punctuation, rejoining false splits
    after common abbreviations ("Dr. Smith arrived." stays one
    sentence)."""
    parts = [p.strip() for p in _SENT_BOUNDARY.split(text) if p.strip()]
    out: list[str] = []
    for p in parts:
        if out:
            last_word = out[-1].rstrip(".").rsplit(None, 1)[-1].lower() \
                if out[-1].rstrip(".") else ""
            if out[-1].endswith(".") and last_word in _ABBREV:
                out[-1] = out[-1] + " " + p
                continue
        out.append(p)
    return out


def pack_chunks(
    token_lists: Sequence[np.ndarray],
    budget: int,
    sep_token: int | None = None,
) -> list[np.ndarray]:
    """Greedily merge adjacent sentence token arrays while the merged
    length stays within ``budget`` tokens (joined by ``sep_token``,
    typically the 'sp' silence phone). A single sentence longer than
    the budget is hard-split at the budget — degraded prosody at the
    cut, but never silent truncation."""
    chunks: list[np.ndarray] = []
    cur: np.ndarray | None = None
    sep = ([] if sep_token is None
           else [np.asarray([sep_token], np.int32)])
    sep_len = len(sep)
    for toks in token_lists:
        toks = np.asarray(toks, np.int32)
        if len(toks) == 0:
            continue
        while len(toks) > budget:  # pathological single sentence
            head, toks = toks[:budget], toks[budget:]
            if cur is not None:
                chunks.append(cur)
                cur = None
            chunks.append(head)
        if len(toks) == 0:
            continue
        if cur is None:
            cur = toks
        elif len(cur) + sep_len + len(toks) <= budget:
            cur = np.concatenate([cur, *sep, toks])
        else:
            chunks.append(cur)
            cur = toks
    if cur is not None and len(cur):
        chunks.append(cur)
    return chunks


def chunk_text(
    text: str,
    tokenize: Callable[[str], np.ndarray],
    budget: int,
    sep_token: int | None = None,
) -> list[np.ndarray]:
    """sentences -> per-sentence tokens -> packed chunks."""
    token_lists = [tokenize(s) for s in sentences(text)]
    return pack_chunks(token_lists, budget, sep_token)
