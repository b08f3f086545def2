"""Greedy CTC decoding, WER/CER error counts and the WER diagnosis page.

The port's own copy of what it uses of ``tpu_speech/eval/wer.py``:
``ctc_greedy_decode``, ``levenshtein``, ``error_counts``, ``align_words`` and
``render_wer_html``. Argmax -> collapse repeats -> drop blanks; word/char
error counts by Levenshtein distance (no editdistance dependency).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def ctc_greedy_decode(
    log_probs: np.ndarray, lengths: np.ndarray, blank_idx: int
) -> List[List[int]]:
    """(B, T, K) -> list of token-id sequences (repeats collapsed, blanks
    removed)."""
    preds = np.asarray(log_probs).argmax(axis=-1)
    out = []
    for i in range(preds.shape[0]):
        seq = preds[i, : int(lengths[i])]
        collapsed = []
        prev = -1
        for s in seq:
            if s != prev and s != blank_idx:
                collapsed.append(int(s))
            prev = s
        out.append(collapsed)
    return out


def levenshtein(a: Sequence, b: Sequence) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def error_counts(hypotheses: Sequence[str], references: Sequence[str],
                 use_cer: bool = False) -> Tuple[int, int]:
    """(total edit distance, total reference tokens) — the additive raw
    counts behind WER/CER, so shards can be summed across processes before
    the final division."""
    if len(hypotheses) != len(references):
        raise ValueError(
            f"{len(hypotheses)} hypotheses vs {len(references)} references"
        )
    errors, total = 0, 0
    for hyp, ref in zip(hypotheses, references):
        h = list(hyp) if use_cer else hyp.split()
        r = list(ref) if use_cer else ref.split()
        errors += levenshtein(h, r)
        total += len(r)
    return errors, total


def align_words(hyp: str, ref: str) -> List[Tuple[str, str, str]]:
    """Minimum-edit alignment of word sequences -> [(op, hyp_word, ref_word)]
    with op in {'ok', 'sub', 'ins', 'del'} (simple_wer_v2.py alignment role)."""
    h, r = hyp.split(), ref.split()
    n, m = len(h), len(r)
    d = np.zeros((n + 1, m + 1), dtype=np.int32)
    d[:, 0] = np.arange(n + 1)
    d[0, :] = np.arange(m + 1)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            d[i, j] = min(
                d[i - 1, j] + 1,                       # ins (extra hyp word)
                d[i, j - 1] + 1,                       # del (missed ref word)
                d[i - 1, j - 1] + (h[i - 1] != r[j - 1]),
            )
    ops = []
    i, j = n, m
    while i > 0 or j > 0:
        if i > 0 and j > 0 and d[i, j] == d[i - 1, j - 1] + (h[i - 1] != r[j - 1]):
            ops.append(("ok" if h[i - 1] == r[j - 1] else "sub",
                        h[i - 1], r[j - 1]))
            i, j = i - 1, j - 1
        elif i > 0 and d[i, j] == d[i - 1, j] + 1:
            ops.append(("ins", h[i - 1], ""))
            i -= 1
        else:
            ops.append(("del", "", r[j - 1]))
            j -= 1
    return ops[::-1]


def render_wer_html(hypotheses: Sequence[str], references: Sequence[str],
                    output_path: str, ids: Sequence[str] = None) -> dict:
    """Write the per-utterance WER diagnosis HTML (the reference's
    simple_wer_v2.write_html / compute_wer.analyze artifact,
    parts/compute_wer.py:24-73): summary WER/SER + every utterance rendered
    with substitutions, insertions, and deletions highlighted.

    Returns {'wer', 'ser', 'sub', 'ins', 'del', 'n_ref_words', 'n_utts'}.
    """
    import html as _html

    if len(hypotheses) != len(references):
        raise ValueError(
            f"{len(hypotheses)} hypotheses vs {len(references)} references"
        )
    n_sub = n_ins = n_del = n_ref = 0
    n_err_utts = 0
    rows = []
    for k, (hyp, ref) in enumerate(zip(hypotheses, references)):
        ops = align_words(hyp, ref)
        s = sum(1 for op, _, _ in ops if op == "sub")
        i = sum(1 for op, _, _ in ops if op == "ins")
        dl = sum(1 for op, _, _ in ops if op == "del")
        n_sub, n_ins, n_del = n_sub + s, n_ins + i, n_del + dl
        n_ref += len(ref.split())
        if s + i + dl:
            n_err_utts += 1
        spans = []
        for op, hw, rw in ops:
            hw, rw = _html.escape(hw), _html.escape(rw)
            if op == "ok":
                spans.append(hw)
            elif op == "sub":
                spans.append(
                    f'<span class="sub">{hw}<del>{rw}</del></span>'
                )
            elif op == "ins":
                spans.append(f'<span class="ins">{hw}</span>')
            else:
                spans.append(f'<span class="del"><del>{rw}</del></span>')
        uid = _html.escape(str(ids[k])) if ids is not None else str(k)
        err = (s + i + dl) / max(len(ref.split()), 1)
        rows.append(
            f"<tr><td>{uid}</td><td>{' '.join(spans)}</td>"
            f"<td>{100 * err:.1f}%</td></tr>"
        )

    wer = (n_sub + n_ins + n_del) / max(n_ref, 1)
    n = max(len(references), 1)
    stats = {
        "wer": wer, "ser": n_err_utts / n, "sub": n_sub, "ins": n_ins,
        "del": n_del, "n_ref_words": n_ref, "n_utts": len(references),
    }
    doc = f"""<!doctype html><html><head><meta charset="utf-8">
<title>WER diagnosis</title><style>
body {{ font-family: monospace; margin: 2em; }}
table {{ border-collapse: collapse; }}
td {{ border: 1px solid #ccc; padding: 4px 8px; vertical-align: top; }}
.sub {{ background: #fff3b0; }}
.ins {{ background: #c4f0c5; }}
.del {{ background: #f6c4c4; }}
del {{ color: #a00; margin-left: 0.3em; }}
</style></head><body>
<h2>WER = {100 * wer:.2f}% &nbsp; SER = {100 * stats['ser']:.2f}%</h2>
<p>{stats['n_utts']} utterances, {n_ref} reference words:
{n_sub} substitutions, {n_ins} insertions, {n_del} deletions.</p>
<p>Legend: <span class="sub">substitution<del>reference</del></span>
<span class="ins">insertion</span>
<span class="del"><del>deletion</del></span></p>
<table><tr><th>id</th><th>alignment</th><th>err</th></tr>
{chr(10).join(rows)}
</table></body></html>
"""
    with open(output_path, "w", encoding="utf-8") as f:
        f.write(doc)
    return stats
