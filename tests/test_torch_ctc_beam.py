"""PyTorch port, decoding and text: CTC prefix beam search with and without
the n-gram LM (``eval/ctc_beam.py``), and the word and subword tokenizers
(``text/tokenizers.py``), each against the JAX package's module on the same
seeded inputs and the same synthetic vocab files.
"""

import numpy as np
import pytest
import torch

from tpu_speech.eval import ctc_beam as jbeam
from tpu_speech.text import tokenizers as jtok
from tpu_speech_torch.eval import ctc_beam as pbeam
from tpu_speech_torch.text import tokenizers as ptok

B = "▁"
LM_ATOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch, as every port test file of tiny work
    (the suite's six workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _log_probs(seed, b, t, v, peaked=True):
    """Seeded (B, T, V) log-softmax rows; ``peaked`` sharpens them, as a
    trained CTC model's frames are."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((b, t, v)) * (3.0 if peaked else 1.0)
    z -= z.max(axis=-1, keepdims=True)
    lp = z - np.log(np.exp(z).sum(axis=-1, keepdims=True))
    lens = rng.integers(max(1, t // 2), t + 1, size=b)
    return lp.astype(np.float32), lens


def _sequences(seed, n, v, lo=1):
    rng = np.random.default_rng(seed)
    return [tuple(int(i) for i in rng.integers(lo, v, size=rng.integers(3, 20)))
            for _ in range(n)]


@pytest.mark.parametrize("v,t,beam,peaked", [
    (5, 12, 2, True), (8, 30, 4, True), (29, 50, 8, False), (40, 64, 16, True),
    (64, 40, 3, False),
])
@pytest.mark.parametrize("blank", [0, -1])
def test_beam_search_labels_equal_jax(v, t, beam, peaked, blank):
    lp, lens = _log_probs(v * 1000 + t, 3, t, v, peaked)
    blank = blank % v
    want = jbeam.ctc_beam_search_batch(lp, lens, blank=blank, beam_width=beam)
    got = pbeam.ctc_beam_search_batch(lp, lens, blank=blank, beam_width=beam)
    assert got == want
    assert all(blank not in seq for seq in got)


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_ngram_lm_scores_equal_jax(order):
    seqs = _sequences(order, 30, 12)
    jlm, plm = jbeam.NGramLM(order).fit(seqs), pbeam.NGramLM(order).fit(seqs)
    rng = np.random.default_rng(7)
    prefixes = [()] + [tuple(s[:k]) for s in seqs[:10] for k in range(1, len(s))]
    prefixes += [tuple(int(i) for i in rng.integers(1, 14, size=5)) for _ in range(20)]
    for prefix in prefixes:
        for nxt in range(1, 14):  # ids 12, 13 never seen: the unigram floor
            assert abs(plm(prefix, nxt) - jlm(prefix, nxt)) <= LM_ATOL


@pytest.mark.parametrize("v,t,beam,alpha,order", [
    (12, 30, 4, 0.5, 3), (12, 48, 8, 1.0, 4), (30, 40, 16, 0.3, 2),
])
def test_beam_search_with_lm_labels_equal_jax(v, t, beam, alpha, order):
    lp, lens = _log_probs(v + t, 4, t, v, peaked=False)
    seqs = _sequences(v, 50, v)
    jlm, plm = jbeam.NGramLM(order).fit(seqs), pbeam.NGramLM(order).fit(seqs)
    want = jbeam.ctc_beam_search_batch(lp, lens, beam_width=beam, lm=jlm, alpha=alpha)
    got = pbeam.ctc_beam_search_batch(lp, lens, beam_width=beam, lm=plm, alpha=alpha)
    assert got == want
    # the LM moves the answer at this weight on at least one utterance
    plain = pbeam.ctc_beam_search_batch(lp, lens, beam_width=beam)
    assert plain != got


def test_beam_width_one_search_and_greedy_agree_on_peaked_frames():
    """On frames whose argmax is far ahead, the beam's best prefix is the
    greedy collapse (the two decoders of one run agree)."""
    from tpu_speech_torch.eval.wer import ctc_greedy_decode

    lp, lens = _log_probs(3, 4, 40, 10, peaked=True)
    lp = lp * 4.0  # sharper still; the rows stay log-probs up to a constant
    lp -= np.log(np.exp(lp).sum(-1, keepdims=True))
    assert pbeam.ctc_beam_search_batch(lp, lens, beam_width=8) == [
        list(s) for s in ctc_greedy_decode(lp, lens, 0)]


# ---- tokenizers --------------------------------------------------------------

VOCAB = ["<unk>", "<s>", "</s>", B, B + "the", B + "a", "the", "he", "ing", "th", "e",
         "t", "h", "a", "i", "n", "g", "s", B + "s", "r", "o", "d", B + "d", "re", "ed",
         "er", "c", "at", B + "cat", "'", "l", "y"]


def _write_vocab(path, scored, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "w", encoding="utf-8") as f:
        for p in VOCAB:
            if scored:
                score = 0.0 if p.startswith("<") else -float(rng.uniform(1, 9))
                f.write(f"{p}\t{score:.6f}\n")
            else:
                f.write(p + "\n")
    return str(path)


TEXTS = ["the cat sat", "he is reading the red hat", "a cat's tiger thing",
         "  the  theatre   ", "zq xy", "", "there there the then",
         "don't stop", "resided in the rain"]


@pytest.mark.parametrize("scored", [True, False])
def test_subword_tokenizer_equals_jax(tmp_path, scored):
    path = _write_vocab(tmp_path / "vocab.tsv", scored)
    jt, pt = jtok.SubwordTokenizer(path), ptok.SubwordTokenizer(path)
    assert pt.vocab_size == jt.vocab_size == len(VOCAB)
    assert (pt.scores is None) == (not scored)
    for text in TEXTS:
        ids = pt.text_to_ids(text)
        assert ids == jt.text_to_ids(text), text
        assert pt.ids_to_text(ids) == jt.ids_to_text(ids)
    rng = np.random.default_rng(1)
    for _ in range(20):
        ids = [int(i) for i in rng.integers(0, len(VOCAB), size=8)]
        assert pt.ids_to_text(ids) == jt.ids_to_text(ids)


def test_subword_unknowns_fuse_into_one_unk(tmp_path):
    """The scored route: a run of characters no piece covers is one <unk>."""
    tok = ptok.SubwordTokenizer(_write_vocab(tmp_path / "vocab.tsv", True))
    ids = tok.text_to_ids("zqx")
    assert ids.count(tok.unk_id) == 1


def test_blank_offset_subword_tokenizer_equals_jax(tmp_path):
    path = _write_vocab(tmp_path / "vocab.tsv", True)
    jt = jtok.BlankOffsetTokenizer(jtok.SubwordTokenizer(path))
    pt = ptok.BlankOffsetTokenizer(ptok.SubwordTokenizer(path))
    assert pt.vocab_size == jt.vocab_size == len(VOCAB) + 1
    for text in TEXTS:
        assert pt.text_to_ids(text) == jt.text_to_ids(text)
        assert 0 not in pt.text_to_ids(text)
        assert pt.ids_to_text([0] + pt.text_to_ids(text)) == jt.ids_to_text(
            [0] + jt.text_to_ids(text))


def test_sentencepiece_model_raises_and_names_the_library(tmp_path):
    with pytest.raises(ImportError, match="sentencepiece"):
        ptok.SubwordTokenizer(str(tmp_path / "spm.model"))


def test_word_tokenizer_equals_jax():
    vocab = ["the", "cat", "sat", "on", "mat"]
    jt, pt = jtok.WordTokenizer(vocab), ptok.WordTokenizer(vocab)
    assert pt.vocab == jt.vocab and pt.unk_id == jt.unk_id
    for text in ("the cat sat on the mat", "a dog", "", "mat  mat"):
        assert pt.text_to_ids(text) == jt.text_to_ids(text)
        assert pt.ids_to_text(pt.text_to_ids(text)) == jt.ids_to_text(jt.text_to_ids(text))
    assert ptok.WordTokenizer(vocab, unk="<w>").vocab[-1] == "<w>"


def test_lm_from_texts_in_the_blank_offset_id_space_equals_jax(tmp_path):
    """run_spiral fits the LM in the model's id space: the subword ids
    shifted by the blank."""
    path = _write_vocab(tmp_path / "vocab.tsv", True)
    jt = jtok.BlankOffsetTokenizer(jtok.SubwordTokenizer(path))
    pt = ptok.BlankOffsetTokenizer(ptok.SubwordTokenizer(path))
    jlm = jbeam.NGramLM.from_texts(TEXTS, jt, order=3)
    plm = pbeam.NGramLM.from_texts(TEXTS, pt, order=3)
    assert {k: dict(v) for k, v in enumerate(plm.counts)} == {
        k: dict(v) for k, v in enumerate(jlm.counts)}
    for prefix in [(), (5,), (5, 29), (4, 7, 11)]:
        for nxt in range(pt.vocab_size):
            assert abs(plm(prefix, nxt) - jlm(prefix, nxt)) <= LM_ATOL
