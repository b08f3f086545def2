"""Text frontend: string -> phoneme/character id sequences.

The port's own copy of ``tpu_speech/text/__init__.py`` (the reference
Grad-TTS frontend): ``text_to_sequence`` with {curly-brace} ARPAbet escapes
and optional CMUdict phonemization, plus ``intersperse`` blank insertion.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence

from tpu_speech_torch.text import cleaners
from tpu_speech_torch.text.cmudict import CMUDict
from tpu_speech_torch.text.symbols import symbols

__all__ = [
    "symbols",
    "CMUDict",
    "text_to_sequence",
    "sequence_to_text",
    "intersperse",
]

_symbol_to_id = {s: i for i, s in enumerate(symbols)}
_id_to_symbol = {i: s for i, s in enumerate(symbols)}

_curly_re = re.compile(r"(.*?)\{(.+?)\}(.*)")


def get_arpabet(word: str, dictionary: CMUDict) -> str:
    prons = dictionary.lookup(word)
    return "{" + prons[0] + "}" if prons is not None else word


def text_to_sequence(
    text: str,
    cleaner_names: Sequence[str] = ("english_cleaners",),
    dictionary: Optional[CMUDict] = None,
) -> List[int]:
    """Convert text to symbol ids; {ARPA} spans bypass cleaning; with a
    dictionary, each cleaned word is phonemized when found."""
    sequence: List[int] = []
    space = _symbols_to_sequence(" ")
    while len(text):
        m = _curly_re.match(text)
        if not m:
            clean = _clean_text(text, cleaner_names)
            if dictionary is not None:
                for word in [get_arpabet(w, dictionary) for w in clean.split(" ")]:
                    if word.startswith("{"):
                        sequence += _arpabet_to_sequence(word[1:-1])
                    else:
                        sequence += _symbols_to_sequence(word)
                    sequence += space
            else:
                sequence += _symbols_to_sequence(clean)
            break
        sequence += _symbols_to_sequence(_clean_text(m.group(1), cleaner_names))
        sequence += _arpabet_to_sequence(m.group(2))
        text = m.group(3)

    # the dictionary branch ends every word with a space: drop the last one
    if dictionary is not None and sequence and sequence[-1] == space[0]:
        sequence = sequence[:-1]
    return sequence


def sequence_to_text(sequence: Sequence[int]) -> str:
    result = ""
    for sid in sequence:
        if sid in _id_to_symbol:
            s = _id_to_symbol[sid]
            if len(s) > 1 and s[0] == "@":
                s = "{%s}" % s[1:]
            result += s
    return result.replace("}{", " ")


def intersperse(seq: Sequence[int], item: int) -> List[int]:
    """Insert ``item`` between (and around) every element: [a,b] -> [i,a,i,b,i]."""
    result = [item] * (len(seq) * 2 + 1)
    result[1::2] = list(seq)
    return result


def _clean_text(text: str, cleaner_names: Sequence[str]) -> str:
    for name in cleaner_names:
        cleaner = getattr(cleaners, name, None)
        if cleaner is None:
            raise ValueError(f"Unknown cleaner: {name}")
        text = cleaner(text)
    return text


def _symbols_to_sequence(syms) -> List[int]:
    return [_symbol_to_id[s] for s in syms if _should_keep(s)]


def _arpabet_to_sequence(text: str) -> List[int]:
    return _symbols_to_sequence(["@" + s for s in text.split()])


def _should_keep(s: str) -> bool:
    return s in _symbol_to_id and s not in ("_", "~")
