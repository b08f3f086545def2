"""Text cleaners that the char parser uses.

The port's own copy of ``collapse_whitespace`` and ``convert_to_ascii`` of
``tpu_speech/text/cleaners.py:57-64``. Transliteration uses unicode NFKD
decomposition instead of the ``unidecode`` package.
"""

from __future__ import annotations

import re
import unicodedata

_whitespace_re = re.compile(r"\s+")


def collapse_whitespace(text: str) -> str:
    return re.sub(_whitespace_re, " ", text)


def convert_to_ascii(text: str) -> str:
    return (
        unicodedata.normalize("NFKD", text).encode("ascii", "ignore").decode("ascii")
    )
