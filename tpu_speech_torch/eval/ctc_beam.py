"""CTC prefix beam search with an optional n-gram LM, on the host.

The port's own copy of ``tpu_speech/eval/ctc_beam.py`` (``ctc_beam_search``,
``ctc_beam_search_batch``, ``NGramLM``), line for line, so that both packages
give the same labels on the same log-probs. Beams are label prefixes that
carry split (ended-in-blank, ended-in-label) log masses, so repeats and
blanks merge correctly (Hannun et al. 2014), with optional shallow fusion of a
token n-gram LM fit from plain text (stupid backoff).

It runs in numpy on the host, as in the JAX package: the network's log-probs
come off the device once a batch, and the O(T·W·K) search is branchy Python.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

LOG0 = -math.inf


def _logsumexp2(a: float, b: float) -> float:
    if a == LOG0:
        return b
    if b == LOG0:
        return a
    m = a if a > b else b
    return m + math.log(math.exp(a - m) + math.exp(b - m))


def ctc_beam_search(
    log_probs: np.ndarray,
    seq_len: int,
    blank: int = 0,
    beam_width: int = 16,
    lm: Optional[Callable[[Tuple[int, ...], int], float]] = None,
    alpha: float = 0.5,
    beta: float = 0.0,
    prune_top_k: int = 32,
) -> List[int]:
    """Decode one utterance: (T, V) log-probs -> best label sequence.

    lm(prefix, next_id) -> log p(next_id | prefix) is fused at each prefix
    extension with weight ``alpha``; ``beta`` is the word/label insertion
    bonus. ``prune_top_k`` caps the per-frame candidate labels (vocab
    pruning, the standard speedup).
    """
    T = int(seq_len)
    V = log_probs.shape[1]
    k = min(prune_top_k, V)
    # beams: prefix -> (logp ending in blank, logp ending in last label)
    beams = {(): (0.0, LOG0)}
    for t in range(T):
        frame = log_probs[t]
        cand = np.argpartition(frame, -k)[-k:] if k < V else np.arange(V)
        nxt: dict = defaultdict(lambda: (LOG0, LOG0))
        for prefix, (p_b, p_nb) in beams.items():
            p_tot = _logsumexp2(p_b, p_nb)
            # extend with blank: prefix unchanged
            b_new, nb_new = nxt[prefix]
            nxt[prefix] = (_logsumexp2(b_new, p_tot + frame[blank]), nb_new)
            for c in cand:
                c = int(c)
                if c == blank:
                    continue
                p_c = float(frame[c])
                if prefix and prefix[-1] == c:
                    # repeat label: extends the SAME prefix only from the
                    # blank-ended mass; the label-ended mass collapses
                    b_new, nb_new = nxt[prefix]
                    nxt[prefix] = (b_new, _logsumexp2(nb_new, p_nb + p_c))
                    ext_mass = p_b
                else:
                    ext_mass = p_tot
                if ext_mass == LOG0:
                    continue
                new_prefix = prefix + (c,)
                score = ext_mass + p_c
                if lm is not None:
                    score += alpha * lm(prefix, c) + beta
                b_new, nb_new = nxt[new_prefix]
                nxt[new_prefix] = (b_new, _logsumexp2(nb_new, score))
        beams = dict(
            sorted(
                nxt.items(),
                key=lambda kv: _logsumexp2(*kv[1]),
                reverse=True,
            )[:beam_width]
        )
    best = max(beams.items(), key=lambda kv: _logsumexp2(*kv[1]))
    return list(best[0])


def ctc_beam_search_batch(
    log_probs: np.ndarray,
    seq_lens: np.ndarray,
    blank: int = 0,
    beam_width: int = 16,
    lm=None,
    alpha: float = 0.5,
    beta: float = 0.0,
) -> List[List[int]]:
    """(B, T, V) log-probs + per-utterance lengths -> label sequences."""
    return [
        ctc_beam_search(
            np.asarray(log_probs[i]), int(seq_lens[i]), blank=blank,
            beam_width=beam_width, lm=lm, alpha=alpha, beta=beta,
        )
        for i in range(log_probs.shape[0])
    ]


class NGramLM:
    """Native character/token n-gram LM with stupid-backoff smoothing.

    Fit from iterable text (e.g. training transcripts) over a tokenizer's id
    space so it plugs straight into ``ctc_beam_search(lm=...)``. Stupid
    backoff (score, not probability) is the standard web-scale choice and
    needs no discount estimation; weight it via the fusion ``alpha``.
    """

    def __init__(self, order: int = 4, backoff: float = 0.4):
        assert order >= 1
        self.order = order
        self.backoff = backoff
        self.counts = [defaultdict(int) for _ in range(order)]  # n-1 -> n
        self.context_totals = [defaultdict(int) for _ in range(order)]

    def fit(self, sequences) -> "NGramLM":
        for seq in sequences:
            seq = tuple(seq)
            for n in range(1, self.order + 1):
                for i in range(len(seq) - n + 1):
                    gram = seq[i : i + n]
                    self.counts[n - 1][gram] += 1
                    self.context_totals[n - 1][gram[:-1]] += 1
        return self

    def __call__(self, prefix: Tuple[int, ...], next_id: int) -> float:
        for n in range(self.order, 0, -1):
            ctx = tuple(prefix[-(n - 1):]) if n > 1 else ()
            gram = ctx + (next_id,)
            c = self.counts[n - 1].get(gram, 0)
            if c > 0:
                total = self.context_totals[n - 1][ctx]
                penalty = (self.order - n) * math.log(self.backoff)
                return math.log(c / total) + penalty
        return math.log(1e-6)  # unseen unigram floor

    @classmethod
    def from_texts(cls, texts: Sequence[str], tokenizer, order: int = 4
                   ) -> "NGramLM":
        return cls(order).fit(
            tokenizer.text_to_ids(t) for t in texts
        )
