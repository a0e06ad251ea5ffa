"""Dependency-free numeral verbalization for es / fr / de / zh / ja.

Copy of ``tts_max_tpu/data/verbalize_multi.py`` (the port imports nothing
of the JAX package). The reference normalizes all six supported languages
through NVIDIA NeMo. English is covered
by data/verbalize.py; this module gives the air-gapped fallback normalizer
real cardinal expansion for the remaining five, so digits never train or
serve unverbalized in any reference language:

  es  1999    -> mil novecientos noventa y nueve
  fr  81      -> quatre-vingt-un
  de  1999    -> (year) neunzehnhundertneunundneunzig
  zh  10505   -> 一万零五百零五 ; 45% -> 百分之四十五
  ja  2025    -> 二千二十五 ; 3.5 -> 三点五

Scope: cardinals, decimals (locale separators: comma for es/fr/de, point
for zh/ja), percent, common currency, zh/ja digit-wise years (1999年 ->
一九九九年). Ordinals/dates/measure-words are left to a real NeMo install.
"""

from __future__ import annotations

import re

# --- Spanish -----------------------------------------------------------------

_ES_ONES = (
    "cero uno dos tres cuatro cinco seis siete ocho nueve diez once doce "
    "trece catorce quince dieciséis diecisiete dieciocho diecinueve veinte "
    "veintiuno veintidós veintitrés veinticuatro veinticinco veintiséis "
    "veintisiete veintiocho veintinueve"
).split()
_ES_TENS = {3: "treinta", 4: "cuarenta", 5: "cincuenta", 6: "sesenta",
            7: "setenta", 8: "ochenta", 9: "noventa"}
_ES_HUNDREDS = {2: "doscientos", 3: "trescientos", 4: "cuatrocientos",
                5: "quinientos", 6: "seiscientos", 7: "setecientos",
                8: "ochocientos", 9: "novecientos"}


def es_int(n: int, apocope: bool = False) -> str:
    """Spanish cardinal; ``apocope`` shortens uno -> un before mil/millón."""
    if n < 0:
        return "menos " + es_int(-n, apocope)
    if n < 30:
        if apocope:
            if n == 1:
                return "un"
            if n == 21:
                return "veintiún"
        return _ES_ONES[n]
    if n < 100:
        t, r = divmod(n, 10)
        w = _ES_TENS[t]
        if r:
            w += " y " + ("un" if apocope and r == 1 else _ES_ONES[r])
        return w
    if n < 1000:
        h, r = divmod(n, 100)
        if n == 100:
            return "cien"
        w = "ciento" if h == 1 else _ES_HUNDREDS[h]
        return w + (" " + es_int(r, apocope) if r else "")
    if n < 10**6:
        th, r = divmod(n, 1000)
        w = "mil" if th == 1 else es_int(th, apocope=True) + " mil"
        return w + (" " + es_int(r) if r else "")
    if n < 10**12:
        m, r = divmod(n, 10**6)
        w = "un millón" if m == 1 else es_int(m, apocope=True) + " millones"
        return w + (" " + es_int(r) if r else "")
    b, r = divmod(n, 10**12)
    w = "un billón" if b == 1 else es_int(b, apocope=True) + " billones"
    return w + (" " + es_int(r) if r else "")


# --- French ------------------------------------------------------------------

_FR_ONES = (
    "zéro un deux trois quatre cinq six sept huit neuf dix onze douze "
    "treize quatorze quinze seize dix-sept dix-huit dix-neuf"
).split()
_FR_TENS = {2: "vingt", 3: "trente", 4: "quarante", 5: "cinquante",
            6: "soixante"}


def _fr_under100(n: int) -> str:
    if n < 20:
        return _FR_ONES[n]
    t, r = divmod(n, 10)
    if t in _FR_TENS:
        base = _FR_TENS[t]
        if r == 0:
            return base
        if r == 1:
            return base + " et un"
        return base + "-" + _FR_ONES[r]
    if t == 7:  # 70-79: soixante-dix .. soixante-dix-neuf
        if n == 71:
            return "soixante et onze"
        return "soixante-" + _FR_ONES[n - 60]
    if t == 8:  # 80 takes a plural s only when final (handled by caller)
        return "quatre-vingts" if n == 80 else "quatre-vingt-" + _FR_ONES[r]
    return "quatre-vingt-" + _FR_ONES[n - 80]  # 90-99


def fr_int(n: int, final: bool = True) -> str:
    """French cardinal; ``final`` controls the plural -s of vingts/cents
    (80 -> quatre-vingts, but 80 000 -> quatre-vingt mille)."""
    if n < 0:
        return "moins " + fr_int(-n, final)
    if n < 100:
        w = _fr_under100(n)
        if n == 80 and not final:
            w = "quatre-vingt"
        return w
    if n < 1000:
        h, r = divmod(n, 100)
        if h == 1:
            w = "cent"
        else:
            w = fr_int(h, final=False) + " cent"
            if r == 0 and final:
                w += "s"
        return w + (" " + fr_int(r, final) if r else "")
    if n < 10**6:
        th, r = divmod(n, 1000)
        w = "mille" if th == 1 else fr_int(th, final=False) + " mille"
        return w + (" " + fr_int(r, final) if r else "")
    if n < 10**9:
        m, r = divmod(n, 10**6)
        w = "un million" if m == 1 else fr_int(m) + " millions"
        return w + (" " + fr_int(r, final) if r else "")
    b, r = divmod(n, 10**9)
    w = "un milliard" if b == 1 else fr_int(b) + " milliards"
    return w + (" " + fr_int(r, final) if r else "")


# --- German ------------------------------------------------------------------

_DE_ONES = (
    "null eins zwei drei vier fünf sechs sieben acht neun zehn elf zwölf "
    "dreizehn vierzehn fünfzehn sechzehn siebzehn achtzehn neunzehn"
).split()
_DE_TENS = {2: "zwanzig", 3: "dreißig", 4: "vierzig", 5: "fünfzig",
            6: "sechzig", 7: "siebzig", 8: "achtzig", 9: "neunzig"}


def _de_under100(n: int, in_compound: bool) -> str:
    if n == 1:
        return "ein" if in_compound else "eins"
    if n < 20:
        return _DE_ONES[n]
    t, r = divmod(n, 10)
    if r == 0:
        return _DE_TENS[t]
    return ("ein" if r == 1 else _DE_ONES[r]) + "und" + _DE_TENS[t]


def de_int(n: int, in_compound: bool = False) -> str:
    """German cardinal (compounds written as one word, standard spelling)."""
    if n < 0:
        return "minus " + de_int(-n)
    if n < 100:
        return _de_under100(n, in_compound)
    if n < 1000:
        h, r = divmod(n, 100)
        w = ("ein" if h == 1 else _DE_ONES[h]) + "hundert"
        return w + (_de_under100(r, in_compound) if r else "")
    if n < 10**6:
        th, r = divmod(n, 1000)
        w = de_int(th, in_compound=True) + "tausend"
        return w + (de_int(r) if r else "")
    if n < 10**9:
        m, r = divmod(n, 10**6)
        w = "eine Million" if m == 1 else de_int(m, True) + " Millionen"
        return w + (" " + de_int(r) if r else "")
    b, r = divmod(n, 10**9)
    w = "eine Milliarde" if b == 1 else de_int(b, True) + " Milliarden"
    return w + (" " + de_int(r) if r else "")


def de_year(n: int) -> str:
    """German year convention: 1100-1999 read in hundreds
    (neunzehnhundertneunundneunzig); otherwise a plain cardinal."""
    if 1100 <= n <= 1999:
        hi, lo = divmod(n, 100)
        return _DE_ONES[hi] + "hundert" + (_de_under100(lo, False) if lo else "")
    return de_int(n)


# --- Chinese -----------------------------------------------------------------

_ZH_DIG = "零一二三四五六七八九"


def _zh_under10000(n: int) -> str:
    s, started, pending_zero = "", False, False
    for v, u in ((1000, "千"), (100, "百"), (10, "十")):
        d = (n // v) % 10
        if d == 0:
            pending_zero = started or pending_zero
            continue
        if pending_zero:
            s += "零"
            pending_zero = False
        if v == 10 and d == 1 and not started:
            s += "十"  # 10-19: 十X, not 一十X
        else:
            s += _ZH_DIG[d] + u
        started = True
    d = n % 10
    if d:
        if pending_zero:
            s += "零"
        s += _ZH_DIG[d]
    return s or "零"


def zh_int(n: int) -> str:
    if n < 0:
        return "负" + zh_int(-n)
    if n == 0:
        return "零"
    yi, rest = divmod(n, 10**8)
    wan, base = divmod(rest, 10**4)
    s = ""
    if yi:
        s += zh_int(yi) + "亿"
    if wan:
        if yi and wan < 1000:
            s += "零"
        s += _zh_under10000(wan) + "万"
    if base:
        if (yi or wan) and base < 1000:
            s += "零"
        s += _zh_under10000(base)
    return s


# --- Japanese ----------------------------------------------------------------

_JA_DIG = "〇一二三四五六七八九"


def _ja_under10000(n: int) -> str:
    s = ""
    for v, u in ((1000, "千"), (100, "百"), (10, "十")):
        d = (n // v) % 10
        if d:
            s += ("" if d == 1 else _JA_DIG[d]) + u
    d = n % 10
    if d:
        s += _JA_DIG[d]
    return s or "〇"


def ja_int(n: int) -> str:
    if n < 0:
        return "マイナス" + ja_int(-n)
    if n == 0:
        return "〇"
    cho, rest = divmod(n, 10**12)
    oku, rest = divmod(rest, 10**8)
    man, base = divmod(rest, 10**4)
    s = ""
    if cho:
        s += _ja_under10000(cho) + "兆"
    if oku:
        s += _ja_under10000(oku) + "億"
    if man:
        s += ("一" if man == 1 else _ja_under10000(man)) + "万"
    if base:
        s += _ja_under10000(base)
    return s


# --- text expansion ----------------------------------------------------------

# es/fr/de locale numbers: "." groups thousands, "," is the decimal separator
_EU_INT = r"(\d{1,3}(?:\.\d{3})+|\d+)"
_RE_EU_NUM = re.compile(
    r"(?<![\w,.:])(-?)" + _EU_INT + r"(?:,(\d+))?(?!\.?\d)(?!,\d)(?![\w:%])"
)
_RE_EU_PCT = re.compile(r"(?<![\w,.])(-?)" + _EU_INT + r"(?:,(\d+))?\s?%")
_RE_EU_CUR = re.compile(r"([$€£])\s?" + _EU_INT + r"(?:,(\d{1,2}))?"
                        r"|" + _EU_INT + r"(?:,(\d{1,2}))?\s?([$€£])")

# zh/ja: point decimals, no thousands grouping in running CJK text.
# ASCII-only word classes: Python's \w matches CJK ideographs, which would
# block every number embedded in running text ("我有25个" -> 有 is \w).
_A = r"0-9A-Za-z_"
_RE_CJK_NUM = re.compile(
    rf"(?<![{_A}.])(-?)(\d+)(?:\.(\d+))?(?![{_A}.])"
)
_RE_CJK_PCT = re.compile(rf"(?<![{_A}.])(-?)(\d+)(?:\.(\d+))?\s?%")
_RE_CJK_YEAR = re.compile(rf"(?<![{_A}.])(\d{{3,4}})\s?(?=年)")

_EU = {
    "es": dict(int=es_int, minus="menos", point="coma",
               digits=_ES_ONES[:10],
               cur={"$": "dólares", "€": "euros", "£": "libras"},
               pct="por ciento", cents_join=" con "),
    "fr": dict(int=fr_int, minus="moins", point="virgule",
               digits=_FR_ONES[:10],
               cur={"$": "dollars", "€": "euros", "£": "livres"},
               pct="pour cent", cents_join=" "),
    "de": dict(int=de_int, minus="minus", point="Komma",
               digits=_DE_ONES[:10],
               cur={"$": "Dollar", "€": "Euro", "£": "Pfund"},
               pct="Prozent", cents_join=" "),
}


def _eu_number(lang: dict, int_part: str, frac: str | None) -> str:
    words = lang["int"](int(int_part.replace(".", "")))
    if frac:
        words += f" {lang['point']} " + " ".join(
            lang["digits"][int(c)] for c in frac
        )
    return words


def _expand_eu(text: str, code: str) -> str:
    lang = _EU[code]

    def num(m: re.Match) -> str:
        sign = f"{lang['minus']} " if m.group(1) else ""
        return sign + _eu_number(lang, m.group(2), m.group(3))

    def pct(m: re.Match) -> str:
        sign = f"{lang['minus']} " if m.group(1) else ""
        return sign + _eu_number(lang, m.group(2), m.group(3)) \
            + " " + lang["pct"]

    def cur(m: re.Match) -> str:
        # amounts read as units + cents ("3,50 €" -> "trois euros
        # cinquante"), not digit-wise decimals
        sym = m.group(1) or m.group(6)
        amount = m.group(2) or m.group(4)
        frac = m.group(3) or m.group(5)
        out = lang["int"](int(amount.replace(".", ""))) \
            + " " + lang["cur"][sym]
        if frac:
            cents = int(frac.ljust(2, "0"))
            if cents:
                out += lang["cents_join"] + lang["int"](cents)
        return out

    text = _RE_EU_CUR.sub(cur, text)
    text = _RE_EU_PCT.sub(pct, text)

    if code == "de":
        # year convention before the generic cardinal pass
        text = re.sub(
            r"(?<![\w,.:])(1[1-9]\d\d)(?!\.?\d)(?!,\d)(?![\w:%-])",
            lambda m: de_year(int(m.group(1))), text,
        )
    return _RE_EU_NUM.sub(num, text)


def _expand_cjk(text: str, code: str) -> str:
    to_words = zh_int if code == "zh" else ja_int
    digits = _ZH_DIG if code == "zh" else _JA_DIG
    minus = "负" if code == "zh" else "マイナス"

    def number(int_part: str, frac: str | None) -> str:
        w = to_words(int(int_part))
        if frac:
            w += "点" + "".join(digits[int(c)] for c in frac)
        return w

    def pct(m: re.Match) -> str:
        w = (minus if m.group(1) else "") + number(m.group(2), m.group(3))
        return "百分之" + w if code == "zh" else w + "パーセント"

    # years before 年 are read digit-wise in both languages
    text = _RE_CJK_YEAR.sub(
        lambda m: "".join(digits[int(c)] for c in m.group(1)), text
    )
    text = _RE_CJK_PCT.sub(pct, text)
    return _RE_CJK_NUM.sub(
        lambda m: (minus if m.group(1) else "")
        + number(m.group(2), m.group(3)),
        text,
    )


def expand(text: str, language: str) -> str:
    """Verbalize numeric entities for ``language`` (es/fr/de/zh/ja).
    English goes through verbalize.expand_en; unknown languages pass
    through unchanged."""
    if language in _EU:
        return _expand_eu(text, language)
    if language in ("zh", "ja"):
        return _expand_cjk(text, language)
    return text
