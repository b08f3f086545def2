"""CMU pronouncing dictionary loader (ARPAbet lookup).

The port's own copy of ``tpu_speech/text/cmudict.py``: the reference
Grad-TTS dictionary format; entries map WORD -> list of pronunciation
strings like 'HH AH0 L OW1'.
"""

from __future__ import annotations

import re

from tpu_speech_torch.text.symbols import ARPABET

_valid_symbol_set = set(ARPABET)
_alt_re = re.compile(r"\([0-9]+\)")


class CMUDict:
    def __init__(self, file_or_path, keep_ambiguous: bool = True):
        if isinstance(file_or_path, str):
            with open(file_or_path, encoding="latin-1") as f:
                entries = _parse(f)
        else:
            entries = _parse(file_or_path)
        if not keep_ambiguous:
            entries = {w: p for w, p in entries.items() if len(p) == 1}
        self._entries = entries

    def __len__(self):
        return len(self._entries)

    def lookup(self, word: str):
        return self._entries.get(word.upper())


def _parse(file):
    entries = {}
    for line in file:
        if len(line) and (("A" <= line[0] <= "Z") or line[0] == "'"):
            parts = line.split("  ")
            if len(parts) < 2:
                continue
            word = re.sub(_alt_re, "", parts[0])
            pron = _validate_pronunciation(parts[1])
            if pron:
                entries.setdefault(word, []).append(pron)
    return entries


def _validate_pronunciation(s: str):
    parts = s.strip().split(" ")
    if any(p not in _valid_symbol_set for p in parts):
        return None
    return " ".join(parts)
