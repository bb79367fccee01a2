# Copied from cmtts_tpu/text/symbols.py (jax-free) so that the port imports nothing of cmtts_tpu.
"""Symbol inventory for the text front-end.

The inventory and its *ordering* must match the reference exactly so that
phoneme IDs (and therefore embedding rows / checkpoints) are compatible
(reference ``text/symbols.py:10-29``: pad + special + punctuation +
letters + @ARPAbet + @pinyin + silences = 360 symbols; the encoder
embedding table has ``len(symbols)+1`` rows, ``model/modules.py:124-126``).

The ARPAbet and pinyin lists are standard public inventories
(keithito/tacotron); we construct them programmatically.
"""

from __future__ import annotations

# 15 ARPAbet vowels carry stress variants ('', 0, 1, 2); 24 consonants do
# not.  Sorted interleaving reproduces the canonical CMUdict ordering.
_ARPABET_VOWELS = (
    "AA AE AH AO AW AY EH ER EY IH IY OW OY UH UW".split()
)
_ARPABET_CONSONANTS = (
    "B CH D DH F G HH JH K L M N NG P R S SH T TH V W Y Z ZH".split()
)

arpabet_symbols: list[str] = sorted(
    [v + s for v in _ARPABET_VOWELS for s in ("", "0", "1", "2")]
    + _ARPABET_CONSONANTS
)

# Mandarin pinyin: 23 initials, 37 finals x 5 tones, plus erhua "rr".
_PINYIN_INITIALS = (
    "b c ch d f g h j k l m n p q r s sh t w x y z zh".split()
)
_PINYIN_FINALS = (
    "a ai an ang ao e ei en eng er i ia ian iang iao ie ii iii in ing "
    "iong iou o ong ou u ua uai uan uang uei uen uo v van ve vn".split()
)
pinyin_symbols: list[str] = _PINYIN_INITIALS + [
    f + tone for f in _PINYIN_FINALS for tone in "12345"
] + ["rr"]

PAD = "_"
_special = "-"
_punctuation = "!'(),.:;? "
_letters = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
_silences = ["@sp", "@spn", "@sil"]

symbols: list[str] = (
    [PAD]
    + list(_special)
    + list(_punctuation)
    + list(_letters)
    + ["@" + s for s in arpabet_symbols]
    + ["@" + s for s in pinyin_symbols]
    + _silences
)

symbol_to_id: dict[str, int] = {s: i for i, s in enumerate(symbols)}
id_to_symbol: dict[int, str] = {i: s for i, s in enumerate(symbols)}

# Vocabulary size of the encoder token embedding (reference adds +1,
# model/modules.py:124-126).
VOCAB_SIZE = len(symbols) + 1
