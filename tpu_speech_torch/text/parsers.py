"""Manifest-transcript parsers for ASR char datasets.

The port's own copy of ``tpu_speech/text/parsers.py``, unchanged but for its
imports. Equivalent of the reference's SPIRAL/nemo/collections/asr/parts/parsers.py
(CharParser :26-111, ENCharParser :113-156, make_parser :161) and the English
text normalization it pulls from parts/cleaners.py:93-101 (transliterate,
lowercase, number/abbreviation expansion, punctuation mapping). The
normalization engines are the native ones in ``tpu_speech_torch.text`` — NFKD
transliteration and the number-to-words engine replace
unidecode/inflect.
"""

from __future__ import annotations

import re
import string as _string
from typing import Callable, List, Optional, Sequence, Union

from tpu_speech_torch.text.cleaners import collapse_whitespace, convert_to_ascii
from tpu_speech_torch.text.numbers import normalize_numbers

# Abbreviation table from the reference ASR cleaners
# (SPIRAL/nemo/collections/asr/parts/cleaners.py:33-64 ABBREVIATIONS_COMMON) —
# a constant data table that must match for normalization parity.
_ABBREVIATIONS = [
    (re.compile(r"\b%s\." % abbr), full)
    for abbr, full in [
        ("ms", "miss"), ("mrs", "misess"), ("mr", "mister"),
        ("messrs", "messeurs"), ("dr", "doctor"), ("drs", "doctors"),
        ("st", "saint"), ("co", "company"), ("jr", "junior"),
        ("sr", "senior"), ("rev", "reverend"), ("hon", "honorable"),
        ("sgt", "sergeant"), ("capt", "captain"), ("maj", "major"),
        ("col", "colonel"), ("lt", "lieutenant"), ("gen", "general"),
        ("prof", "professor"), ("lb", "pounds"), ("rep", "representative"),
        ("st", "street"), ("ave", "avenue"), ("etc", "et cetera"),
        ("jan", "january"), ("feb", "february"), ("mar", "march"),
        ("apr", "april"), ("jun", "june"), ("jul", "july"),
        ("aug", "august"), ("sep", "september"), ("oct", "october"),
        ("nov", "november"), ("dec", "december"),
    ]
]


class CharParser:
    """Raw transcript string -> list of label ids (reference parsers.py:26).

    Multi-char labels are matched per whitespace-split word; spaces between
    words map to the ``' '`` label; OOV chars map to ``unk_id`` and ids equal
    to ``blank_id`` are filtered (so the default unk_id == blank_id == -1
    silently drops OOV).
    """

    def __init__(
        self,
        labels: Sequence[str],
        *,
        unk_id: int = -1,
        blank_id: int = -1,
        do_normalize: bool = True,
        do_lowercase: bool = True,
        add_end_space: bool = False,
    ):
        self.labels = list(labels)
        self._unk_id = unk_id
        self._blank_id = blank_id
        self._do_normalize = do_normalize
        self._do_lowercase = do_lowercase
        self._labels_map = {label: i for i, label in enumerate(self.labels)}
        self._special_labels = {label for label in self.labels if len(label) > 1}
        self.add_end_space = add_end_space

    def __call__(self, text: str) -> Optional[List[int]]:
        if self._do_normalize:
            text = self._normalize(text)
            if text is None:
                return None
        return self._tokenize(text)

    def _normalize(self, text: str) -> Optional[str]:
        text = text.strip()
        if self._do_lowercase:
            text = text.lower()
        return text

    def _tokenize(self, text: str) -> List[int]:
        space_id = self._labels_map.get(" ", self._unk_id)
        tokens: List[int] = []
        for word_id, word in enumerate(text.split(" ")):
            if word_id != 0 and not self.add_end_space:
                tokens.append(space_id)
            if word in self._special_labels:
                tokens.append(self._labels_map[word])
                continue
            tokens.extend(self._labels_map.get(c, self._unk_id) for c in word)
            if self.add_end_space:
                tokens.append(space_id)
        return [t for t in tokens if t != self._blank_id]


class ENCharParser(CharParser):
    """English-specific normalization (reference parsers.py:113 +
    cleaners.py:93-101): transliterate to ascii, lowercase, expand numbers
    and abbreviations, map '+/&/%' to words and remaining punctuation to
    space."""

    PUNCTUATION_TO_REPLACE = {"+": "plus", "&": "and", "%": "percent"}

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        punctuation = _string.punctuation
        for ch in self.PUNCTUATION_TO_REPLACE:
            punctuation = punctuation.replace(ch, "")
        for label in self.labels:
            punctuation = punctuation.replace(label, "")
        self._table = str.maketrans(punctuation, " " * len(punctuation))

    def _normalize(self, text: str) -> Optional[str]:
        try:
            text = convert_to_ascii(text)
            text = text.lower()
            text = collapse_whitespace(text)
            text = normalize_numbers(text)
            for regex, replacement in _ABBREVIATIONS:
                text = re.sub(regex, replacement, text)
            for punc, replacement in self.PUNCTUATION_TO_REPLACE.items():
                text = re.sub(re.escape(punc), f" {replacement} ", text)
            text = text.translate(self._table)
            return collapse_whitespace(text).strip()
        except Exception:
            return None


NAME_TO_PARSER = {"base": CharParser, "en": ENCharParser}


def make_parser(
    labels: Optional[Sequence[str]] = None,
    name: str = "base",
    **kwargs,
) -> Union[CharParser, Callable[[str], Optional[List[int]]]]:
    """Build a parser by registry name (reference parsers.py:161)."""
    if name not in NAME_TO_PARSER:
        raise ValueError(
            f"unknown parser '{name}' (have {sorted(NAME_TO_PARSER)})"
        )
    if labels is None:
        raise ValueError("labels are required to build a parser")
    return NAME_TO_PARSER[name](labels, **kwargs)
