"""ASR tokenizers: the character tokenizer and the CTC blank offset.

The port's own copy of what it uses of ``tpu_speech/text/tokenizers.py``:
``DEFAULT_CHAR_LABELS``, ``CharTokenizer`` and ``BlankOffsetTokenizer``. The
word, subword and HuggingFace tokenizers come with the slices that need them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

DEFAULT_CHAR_LABELS = [
    " ", "a", "b", "c", "d", "e", "f", "g", "h", "i", "j", "k", "l", "m",
    "n", "o", "p", "q", "r", "s", "t", "u", "v", "w", "x", "y", "z", "'",
]


class CharTokenizer:
    """Char-level tokenizer. ``parser='en'`` applies the reference char
    datasets' default English transcript normalization (transliterate,
    number/abbreviation expansion, punctuation mapping —
    audio_to_text.py:446 ``parser='en'`` + parts/parsers.py ENCharParser);
    ``parser='base'`` is strip+lowercase; ``parser=None`` is the raw
    lowercase char map (legacy behavior, OOV dropped)."""

    def __init__(self, labels: Sequence[str] = tuple(DEFAULT_CHAR_LABELS),
                 parser: Optional[str] = "en"):
        self.labels = list(labels)
        self._map = {c: i for i, c in enumerate(self.labels)}
        if parser is None:
            self._parser = None
        else:
            from tpu_speech_torch.text.parsers import make_parser

            self._parser = make_parser(self.labels, name=parser)

    @property
    def vocab_size(self) -> int:
        return len(self.labels)

    def text_to_ids(self, text: str) -> List[int]:
        if self._parser is not None:
            ids = self._parser(text)
            return ids if ids is not None else []
        return [self._map[c] for c in text.lower() if c in self._map]

    def ids_to_text(self, ids: Sequence[int]) -> str:
        return "".join(self.labels[i] for i in ids if 0 <= i < len(self.labels))



class BlankOffsetTokenizer:
    """Wraps a tokenizer so id 0 is reserved for the CTC blank
    (blank_pos='vocab_first'): token ids are shifted up by one."""

    def __init__(self, base):
        self.base = base

    @property
    def vocab_size(self) -> int:
        return self.base.vocab_size + 1

    def text_to_ids(self, text: str) -> List[int]:
        return [i + 1 for i in self.base.text_to_ids(text)]

    def ids_to_text(self, ids: Sequence[int]) -> str:
        return self.base.ids_to_text([i - 1 for i in ids if i >= 1])
