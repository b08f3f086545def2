"""Number -> words expansion for English text normalization.

The port's own copy of ``tpu_speech/text/numbers.py``, unchanged. Native
implementation of the behaviors the reference gets from the ``inflect``
package (Grad-TTS/text/numbers.py): cardinal words with scale-group commas,
ordinals, year-style two-digit grouping with 'oh', and currency expansion.
"""

from __future__ import annotations

import re

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight", "nine",
    "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen", "sixteen",
    "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy", "eighty",
    "ninety",
]
_SCALES = [
    "", "thousand", "million", "billion", "trillion", "quadrillion", "quintillion",
]

_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _two_words(n: int) -> str:
    if n < 20:
        return _ONES[n]
    tens, ones = divmod(n, 10)
    return _TENS[tens] + ("-" + _ONES[ones] if ones else "")


def _three_words(n: int) -> str:
    hundreds, rest = divmod(n, 100)
    parts = []
    if hundreds:
        parts.append(_ONES[hundreds] + " hundred")
    if rest:
        parts.append(_two_words(rest))
    return " ".join(parts)


def number_to_words(n: int) -> str:
    """Cardinal words; scale groups joined with ', ' (inflect style)."""
    if n == 0:
        return "zero"
    groups = []
    scale = 0
    while n > 0:
        n, g = divmod(n, 1000)
        if g:
            word = _three_words(g)
            if scale:
                word += " " + _SCALES[scale]
            groups.append(word)
        scale += 1
    return ", ".join(reversed(groups))


def ordinal_to_words(n: int) -> str:
    card = number_to_words(n)
    head, _, last = card.rpartition(" ")
    pre, _, final = last.rpartition("-")
    if final in _ORDINAL_IRREGULAR:
        final = _ORDINAL_IRREGULAR[final]
    elif final.endswith("y"):
        final = final[:-1] + "ieth"
    else:
        final = final + "th"
    last = (pre + "-" if pre else "") + final
    return (head + " " if head else "") + last


def year_style_words(n: int) -> str:
    """Two-digit grouping: 1999 -> 'nineteen ninety-nine', 1905 -> 'nineteen oh five'."""
    s = str(n)
    if len(s) % 2:
        s = "0" + s
    parts = []
    for i in range(0, len(s), 2):
        g = s[i : i + 2]
        if g == "00":
            parts.append("hundred")
        elif g[0] == "0":
            parts.append("oh " + _ONES[int(g[1])])
        else:
            parts.append(_two_words(int(g)))
    return " ".join(parts)


_comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9\,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ordinal_re = re.compile(r"[0-9]+(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")


def _remove_commas(m):
    return m.group(1).replace(",", "")


def _expand_decimal_point(m):
    return m.group(1).replace(".", " point ")


def _expand_dollars(m):
    match = m.group(1)
    parts = match.split(".")
    if len(parts) > 2:
        return match + " dollars"
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        dollar_unit = "dollar" if dollars == 1 else "dollars"
        cent_unit = "cent" if cents == 1 else "cents"
        return "%s %s, %s %s" % (dollars, dollar_unit, cents, cent_unit)
    elif dollars:
        return "%s %s" % (dollars, "dollar" if dollars == 1 else "dollars")
    elif cents:
        return "%s %s" % (cents, "cent" if cents == 1 else "cents")
    return "zero dollars"


def _expand_ordinal(m):
    return ordinal_to_words(int(m.group(0)[:-2]))


def _expand_number(m):
    num = int(m.group(0))
    if 1000 < num < 3000:
        if num == 2000:
            return "two thousand"
        if 2000 < num < 2010:
            return "two thousand " + number_to_words(num % 100)
        if num % 100 == 0:
            return number_to_words(num // 100) + " hundred"
        return year_style_words(num)
    return number_to_words(num)


def normalize_numbers(text: str) -> str:
    text = re.sub(_comma_number_re, _remove_commas, text)
    text = re.sub(_pounds_re, r"\1 pounds", text)
    text = re.sub(_dollars_re, _expand_dollars, text)
    text = re.sub(_decimal_number_re, _expand_decimal_point, text)
    text = re.sub(_ordinal_re, _expand_ordinal, text)
    text = re.sub(_number_re, _expand_number, text)
    return text
