"""ASR tokenizers: character, word and subword, and the CTC blank offset.

The port's own copy of ``tpu_speech/text/tokenizers.py``:
``DEFAULT_CHAR_LABELS``, ``CharTokenizer``, ``WordTokenizer:54``,
``SubwordTokenizer:73`` (its vocab-file route: ``piece\tscore`` lines encode
by unigram Viterbi with SentencePiece's unknown model, unscored lists by
greedy longest match) and ``BlankOffsetTokenizer``. A sentencepiece
``.model`` file needs the ``sentencepiece`` library, which the port does not
use yet; ``HuggingFaceTokenizer`` (``transformers``) is not ported either
(ROADMAP Queue 1).
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


class WordTokenizer:
    def __init__(self, vocab: Sequence[str], unk: str = "<unk>"):
        self.vocab = list(vocab)
        if unk not in self.vocab:
            self.vocab.append(unk)
        self._map = {w: i for i, w in enumerate(self.vocab)}
        self.unk_id = self._map[unk]

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def text_to_ids(self, text: str) -> List[int]:
        return [self._map.get(w, self.unk_id) for w in text.split()]

    def ids_to_text(self, ids: Sequence[int]) -> str:
        return " ".join(self.vocab[i] for i in ids)


class SubwordTokenizer:
    """Unigram/BPE-style subword tokenizer over a vocab file: one piece per
    line, optionally ``piece\tscore`` (the SentencePiece ``.vocab`` export;
    scores are unigram log-probs).

    - scored vocab: unigram Viterbi. Per whitespace word, the segmentation of
      '▁' + word with the largest sum of piece log-probs, with SentencePiece's
      unknown-character model (min_score - 10 a character, consecutive
      unknowns fused into one <unk>).
    - unscored vocab: greedy longest match.

    Control symbols (``<...>``) never match text.
    """

    WORD_BOUNDARY = "▁"
    UNK_PENALTY = 10.0  # sentencepiece kUnkPenalty, unigram_model.cc

    def __init__(self, model_or_vocab_path: str):
        self.scores: Optional[List[float]] = None
        if model_or_vocab_path.endswith(".model"):
            raise ImportError(
                f"{model_or_vocab_path}: a sentencepiece .model needs the sentencepiece "
                "library, which the port does not use yet (ROADMAP Queue 1); pass the "
                "model's 'piece\tscore' vocab file instead")
        self.pieces = []
        scores: List[float] = []
        has_scores = False
        with open(model_or_vocab_path, encoding="utf-8") as f:
            for line in f:
                if not line.strip():
                    continue
                parts = line.rstrip("\n").split("\t")
                self.pieces.append(parts[0])
                if len(parts) > 1:
                    has_scores = True
                    scores.append(float(parts[1]))
                else:
                    scores.append(0.0)
        if has_scores:
            self.scores = scores
        self._map = {p: i for i, p in enumerate(self.pieces)}
        self._max_len = max(len(p) for p in self.pieces)
        self.unk_id = self._map.get("<unk>", 0)
        self._match_map = {
            p: i for p, i in self._map.items()
            if not (p.startswith("<") and p.endswith(">"))
        }

    @property
    def vocab_size(self) -> int:
        return len(self.pieces)

    def _viterbi_word(self, chunk: str) -> List[int]:
        """Best-path unigram segmentation of one '▁'-prefixed word."""
        n = len(chunk)
        neg = float("-inf")
        unk_score = min(self.scores) - self.UNK_PENALTY
        best = [neg] * (n + 1)
        best[0] = 0.0
        back: List[Optional[tuple]] = [None] * (n + 1)
        for i in range(n):
            if best[i] == neg:
                continue
            for ln in range(1, min(self._max_len, n - i) + 1):
                pid = self._match_map.get(chunk[i:i + ln])
                if pid is None:
                    continue
                s = best[i] + self.scores[pid]
                if s > best[i + ln]:
                    best[i + ln] = s
                    back[i + ln] = (i, pid)
            s = best[i] + unk_score
            if s > best[i + 1]:
                best[i + 1] = s
                back[i + 1] = (i, self.unk_id)
        ids: List[int] = []
        pos = n
        while pos > 0:
            start, pid = back[pos]
            ids.append(pid)
            pos = start
        ids.reverse()
        fused: List[int] = []  # consecutive unknown characters: one <unk>
        for pid in ids:
            if pid == self.unk_id and fused and fused[-1] == self.unk_id:
                continue
            fused.append(pid)
        return fused

    def _greedy_word(self, chunk: str) -> List[int]:
        ids: List[int] = []
        i = 0
        while i < len(chunk):
            match: Optional[int] = None
            for ln in range(min(self._max_len, len(chunk) - i), 0, -1):
                piece = chunk[i:i + ln]
                if piece in self._match_map:
                    match = self._match_map[piece]
                    i += ln
                    break
            if match is None:
                match = self.unk_id
                i += 1
            ids.append(match)
        return ids

    def text_to_ids(self, text: str) -> List[int]:
        segment = self._viterbi_word if self.scores else self._greedy_word
        ids: List[int] = []
        for word in text.strip().split():
            ids.extend(segment(self.WORD_BOUNDARY + word))
        return ids

    def ids_to_text(self, ids: Sequence[int]) -> str:
        text = "".join(self.pieces[i] for i in ids if 0 <= i < len(self.pieces))
        return text.replace(self.WORD_BOUNDARY, " ").strip()


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
