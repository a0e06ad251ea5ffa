"""Dependency-free English numeral/currency/time verbalization.

Copy of ``tts_max_tpu/data/verbalize.py`` (the port imports nothing of the
JAX package). The reference normalizes text through NVIDIA NeMo; on an air-gapped
image NeMo is unavailable, and a TTS model trained/served on raw digits
mispronounces every number. This module gives the fallback normalizer a
real verbalization pass for English:

  integers            1234        -> one thousand two hundred thirty-four
  decimals            3.14        -> three point one four
  negatives           -5          -> minus five
  ordinals            2nd, 23rd   -> second, twenty-third
  currency            $3.50, £5   -> three dollars and fifty cents, five pounds
  percentages         45%         -> forty-five percent
  clock times         3:05pm      -> three oh five p m
  years               1999, 2025  -> nineteen ninety-nine, twenty twenty-five

Not handled (kept for a real NeMo install): slashed dates (locale-ambiguous),
fractions, roman numerals, unit abbreviations.
"""

from __future__ import annotations

import re

_ONES = (
    "zero one two three four five six seven eight nine ten eleven twelve "
    "thirteen fourteen fifteen sixteen seventeen eighteen nineteen"
).split()
_TENS = "zero ten twenty thirty forty fifty sixty seventy eighty ninety".split()
_SCALES = (
    (10**12, "trillion"),
    (10**9, "billion"),
    (10**6, "million"),
    (10**3, "thousand"),
    (100, "hundred"),
)
_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}
_CURRENCIES = {
    "$": ("dollar", "cent"),
    "£": ("pound", "penny"),
    "€": ("euro", "cent"),
    "¥": ("yen", None),
}


def int_to_words(n: int) -> str:
    if n < 0:
        return "minus " + int_to_words(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        tens, rest = divmod(n, 10)
        return _TENS[tens] + (f"-{_ONES[rest]}" if rest else "")
    for value, name in _SCALES:
        if n >= value:
            head, rest = divmod(n, value)
            out = f"{int_to_words(head)} {name}"
            return f"{out} {int_to_words(rest)}" if rest else out
    raise AssertionError(n)


def digits_to_words(s: str) -> str:
    return " ".join(_ONES[int(c)] if c.isdigit() else c for c in s)


def ordinal_to_words(n: int) -> str:
    words = int_to_words(n)
    head, _, last = words.rpartition(" ")
    stem, _, hyph_last = last.rpartition("-")
    irregular = _ORDINAL_IRREGULAR.get(hyph_last)
    if irregular:
        last = (stem + "-" if stem else "") + irregular
    elif hyph_last.endswith("ty"):
        last = (stem + "-" if stem else "") + hyph_last[:-1] + "ieth"
    else:
        last = last + "th"
    return f"{head} {last}" if head else last


def year_to_words(n: int) -> str:
    """Spoken-year convention: pairs of digits ('nineteen ninety-nine'),
    'oh' for a zero tens digit, 'N hundred' for round hundreds, and
    'two thousand (N)' for 2000-2009."""
    if 2000 <= n <= 2009:
        rest = n - 2000
        return "two thousand" + (f" {_ONES[rest]}" if rest else "")
    hi, lo = divmod(n, 100)
    if lo == 0:
        return f"{int_to_words(hi)} hundred"
    if lo < 10:
        return f"{int_to_words(hi)} oh {_ONES[lo]}"
    return f"{int_to_words(hi)} {int_to_words(lo)}"


def _num(s: str) -> int:
    return int(s.replace(",", ""))


def _number_words(int_part: str, frac_part: str | None) -> str:
    n = _num(int_part)
    words = int_to_words(n) if len(str(n)) <= 15 else digits_to_words(str(n))
    if frac_part:
        words += " point " + digits_to_words(frac_part)
    return words


def _expand_currency(m: re.Match) -> str:
    unit, cent = _CURRENCIES[m.group(1)]
    n = _num(m.group(2))
    frac = m.group(4)
    main = int_to_words(n)
    if unit == "penny":
        main += " pence" if n != 1 else " penny"
    elif cent is None:
        main += f" {unit}"
    else:
        main += f" {unit}" + ("s" if n != 1 else "")
    if frac and cent:
        c = int(frac.ljust(2, "0"))
        if c:
            sub = "pence" if cent == "penny" else (
                cent + ("s" if c != 1 else ""))
            main += f" and {int_to_words(c)} {sub}"
    return main


def _expand_time(m: re.Match) -> str:
    hour, minute = int(m.group(1)), int(m.group(2))
    if hour > 23 or minute > 59:
        return m.group(0)
    out = int_to_words(hour)
    if minute == 0:
        out += " o'clock"
    elif minute < 10:
        out += f" oh {_ONES[minute]}"
    else:
        out += f" {int_to_words(minute)}"
    suffix = m.group(3)
    if suffix:
        out += " " + " ".join(suffix.strip().replace(".", "").lower())
    return out


_RE_TIME = re.compile(r"\b(\d{1,2}):(\d{2})(?![\d:])(?:\s?([ap]\.?m\.?\b))?",
                      re.IGNORECASE)
# Thousands separators match structurally (1,234,567) so list punctuation is
# never consumed ("buy 2, get 1 free" keeps its comma); the trailing
# lookaheads allow a sentence-terminating period ("I have 3.") while decimal
# and version continuations ("3.14", "3.5.2") still take — or block — the
# fractional branch.
_INT = r"(\d{1,3}(?:,\d{3})+|\d+)"
_RE_CURRENCY = re.compile(r"([$£€¥])\s?" + _INT + r"(\.(\d{1,2}))?")
_RE_PERCENT = re.compile(r"(?<![\w.])(-?)" + _INT + r"(?:\.(\d+))?\s?%")
_RE_ORDINAL = re.compile(r"\b" + _INT + r"(st|nd|rd|th)\b", re.IGNORECASE)
# Standalone 4-digit 1100-2099 reads as a year (the common-case convention;
# NeMo resolves this with a context tagger, a fallback cannot).
_RE_YEAR = re.compile(
    r"(?<![\w,.:$£€¥-])(1[1-9]\d\d|20\d\d)(s?)(?!\.?\d)(?!,\d)(?![\w:%-])"
)
_RE_NUMBER = re.compile(
    r"(?<![\w.:])(-?)" + _INT + r"(?:\.(\d+))?(?!\.?\d)(?![\w:%])"
)


def _expand_year(m: re.Match) -> str:
    words = year_to_words(int(m.group(1)))
    if m.group(2):  # decade: "1990s" -> "nineteen nineties"
        head, _, last = words.rpartition(" ")
        if last.endswith("y"):
            last = last[:-1] + "ies"
        else:
            last += "s"
        words = f"{head} {last}" if head else last
    return words


def expand_en(text: str) -> str:
    """Verbalize numeric entities in English text, longest-pattern first."""
    text = _RE_TIME.sub(_expand_time, text)
    text = _RE_CURRENCY.sub(_expand_currency, text)
    text = _RE_PERCENT.sub(
        lambda m: ("minus " if m.group(1) else "")
        + _number_words(m.group(2), m.group(3))
        + " percent",
        text,
    )
    text = _RE_ORDINAL.sub(lambda m: ordinal_to_words(_num(m.group(1))), text)
    text = _RE_YEAR.sub(_expand_year, text)
    text = _RE_NUMBER.sub(
        lambda m: ("minus " if m.group(1) else "")
        + _number_words(m.group(2), m.group(3)),
        text,
    )
    return text
