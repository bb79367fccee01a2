# Copied from cmtts_tpu/text/numbers_norm.py (jax-free) so that the port imports nothing of cmtts_tpu.
"""English number normalization for the text cleaner.

Behavior-compatible with the keithito pipeline the reference uses
(reference ``text/numbers.py``): expands commas, decimals, dollars/pounds,
ordinals and cardinals to words.  We implement number-to-words natively
(no ``inflect`` dependency).
"""

from __future__ import annotations

import re

_comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9\,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ordinal_re = re.compile(r"[0-9]+(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")

_UNITS = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALES = [
    (10 ** 12, "trillion"),
    (10 ** 9, "billion"),
    (10 ** 6, "million"),
    (10 ** 3, "thousand"),
]

_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _below_hundred(n: int) -> str:
    if n < 20:
        return _UNITS[n]
    tens, unit = divmod(n, 10)
    return _TENS[tens] + ("-" + _UNITS[unit] if unit else "")


def _below_thousand(n: int) -> str:
    hundreds, rest = divmod(n, 100)
    parts = []
    if hundreds:
        parts.append(_UNITS[hundreds] + " hundred")
    if rest:
        parts.append(_below_hundred(rest))
    return " ".join(parts) if parts else "zero"


def number_to_words(n: int) -> str:
    """Cardinal words for a non-negative integer."""
    if n == 0:
        return "zero"
    parts = []
    for scale, name in _SCALES:
        q, n = divmod(n, scale)
        if q:
            parts.append(_below_thousand(q) + " " + name)
    if n:
        parts.append(_below_thousand(n))
    return " ".join(parts)


def number_to_ordinal_words(n: int) -> str:
    words = number_to_words(n)
    head, _, last = words.rpartition(" ")
    if "-" in last:
        pre, _, final = last.rpartition("-")
        last_ord = pre + "-" + _ordinal_word(final)
    else:
        last_ord = _ordinal_word(last)
    return (head + " " + last_ord).strip()


def _ordinal_word(word: str) -> str:
    if word in _ORDINAL_IRREGULAR:
        return _ORDINAL_IRREGULAR[word]
    if word.endswith("y"):
        return word[:-1] + "ieth"
    if word.endswith(("hundred", "thousand", "million", "billion", "trillion")):
        return word + "th"
    return word + "th"


def _year_to_words(n: int) -> str:
    """Read 4-digit years the way inflect's ``group=2`` does (e.g. 1806 ->
    'eighteen six' is not standard; keithito reads 1800-2099 specially)."""
    if 1000 <= n < 3000:
        if n % 100 == 0 and n % 1000 != 0:
            return number_to_words(n // 100) + " hundred"
        if n % 1000 == 0:
            return number_to_words(n)
        hi, lo = divmod(n, 100)
        if lo < 10:
            return number_to_words(hi) + " oh " + number_to_words(lo)
        return number_to_words(hi) + " " + number_to_words(lo)
    return number_to_words(n)


def _remove_commas(m: re.Match) -> str:
    return m.group(1).replace(",", "")


def _expand_decimal_point(m: re.Match) -> str:
    whole, _, frac = m.group(1).partition(".")
    digits = " ".join(_UNITS[int(d)] for d in frac)
    return number_to_words(int(whole)) + " point " + digits


def _expand_dollars(m: re.Match) -> str:
    match = m.group(1)
    parts = match.split(".")
    if len(parts) > 2:
        return match + " dollars"
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1].ljust(2, "0")[:2]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        dollar_unit = "dollar" if dollars == 1 else "dollars"
        cent_unit = "cent" if cents == 1 else "cents"
        return "%s %s, %s %s" % (
            number_to_words(dollars), dollar_unit, number_to_words(cents), cent_unit)
    if dollars:
        dollar_unit = "dollar" if dollars == 1 else "dollars"
        return "%s %s" % (number_to_words(dollars), dollar_unit)
    if cents:
        cent_unit = "cent" if cents == 1 else "cents"
        return "%s %s" % (number_to_words(cents), cent_unit)
    return "zero dollars"


def _expand_ordinal(m: re.Match) -> str:
    return number_to_ordinal_words(int(m.group(0)[:-2]))


def _expand_number(m: re.Match) -> str:
    num = int(m.group(0))
    if 1000 < num < 3000:
        if num == 2000:
            return "two thousand"
        if 2000 < num < 2010:
            return "two thousand " + number_to_words(num % 100)
        if num % 100 == 0:
            return number_to_words(num // 100) + " hundred"
        return _year_to_words(num)
    return number_to_words(num)


def normalize_numbers(text: str) -> str:
    text = re.sub(_comma_number_re, _remove_commas, text)
    text = re.sub(_pounds_re, r"\1 pounds", text)
    text = re.sub(_dollars_re, _expand_dollars, text)
    text = re.sub(_decimal_number_re, _expand_decimal_point, text)
    text = re.sub(_ordinal_re, _expand_ordinal, text)
    text = re.sub(_number_re, _expand_number, text)
    return text
