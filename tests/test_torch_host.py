"""The port's copies of the host-side code against the JAX package's originals.

``tpu_speech_torch`` keeps its own copies of the config dataclasses and
overrides, the tokenizers, the TTS text frontend, the WER tools, the SPIRAL
data pipeline, the DiffVC and GE2E data paths (``utils/config.py``,
``text/``, ``eval/wer.py``, ``data/``), the plotting helpers and the
speaker-data preprocessing CLI. Each is held here against the module it was copied from, on the
same inputs. SPIRAL's data options (tar shards, duration buckets, the mu-law
wire) give the JAX package's batches bit for bit, and a runner epoch runs on
each.
"""

import dataclasses
import json
import os
import random
import shutil

import numpy as np
import pytest

from tpu_speech.data import loader as j_loader
from tpu_speech.data import spiral as j_data
from tpu_speech.data.wav import read_wav as j_read_wav
from tpu_speech.data.wav import write_wav
from tpu_speech import text as j_text
from tpu_speech.eval import wer as j_wer
from tpu_speech.text import cleaners as j_cleaners
from tpu_speech.text import tokenizers as j_tok
from tpu_speech.utils import config as j_cfg
from tpu_speech_torch.data import loader as t_loader
from tpu_speech_torch.data import spiral as t_data
from tpu_speech_torch.data.wav import read_wav as t_read_wav
from tpu_speech_torch import text as t_text
from tpu_speech_torch.data.wav import write_wav as t_write_wav
from tpu_speech_torch.eval import wer as t_wer
from tpu_speech_torch.text import cleaners as t_cleaners
from tpu_speech_torch.text import tokenizers as t_tok
from tpu_speech_torch.utils import config as t_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONFIG_CLASSES = ("AdamWParams", "AdamParams", "NovogradParams", "SGDParams", "SchedParams",
                  "AudioDatasetConfig", "DecoderConfig", "NoisePerturbConfig", "TrainerConfig",
                  "ExpManagerConfig", "SpiralModelConfig", "RunConfig")


@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_config_defaults_equal(name):
    ours, theirs = getattr(t_cfg, name), getattr(j_cfg, name)
    assert [f.name for f in dataclasses.fields(ours)] == [
        f.name for f in dataclasses.fields(theirs)]
    assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())


OVERRIDES = (
    ["trainer.max_steps=7", "model.optim.lr=3e-3"],
    ["model.validation_ds.batch_size=5", "model.validation_ds.shuffle=false"],
    ["model.optim.sched.warmup_ratio=0.1", "model.optim.betas=[0.8, 0.9]"],
    ["model.noise_perturb.min_snr_db=5", "model.labels=[a, b]"],
)


@pytest.mark.parametrize("specs", OVERRIDES, ids=lambda s: s[0].split("=")[0])
def test_apply_override_same_tree(specs):
    trees = []
    for mod in (t_cfg, j_cfg):
        cfg = mod.RunConfig()
        cfg.model.optim.sched = mod.SchedParams()
        for spec in specs:
            mod.apply_override(cfg, *mod.parse_cli_override(spec))
        trees.append(dataclasses.asdict(cfg))
    assert trees[0] == trees[1]


def test_apply_override_refuses_unknown_keys_alike():
    errors = []
    for mod in (t_cfg, j_cfg):
        with pytest.raises(KeyError) as e:
            mod.apply_override(mod.RunConfig(), "model.optim.nope", 1)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


TEXTS = ("Hello, World!", "Dr. Smith paid $3.50 on Jan. 2nd", "it's 1,234 m & 5% +",
         "Café naïve façade", "  many   spaces\tand\nlines  ", "")


@pytest.mark.parametrize("parser", ["en", "base", None])
def test_char_tokenizer_same(parser):
    ours, theirs = t_tok.CharTokenizer(parser=parser), j_tok.CharTokenizer(parser=parser)
    for text in TEXTS:
        ids = theirs.text_to_ids(text)
        assert ours.text_to_ids(text) == ids
        assert ours.ids_to_text(ids) == theirs.ids_to_text(ids)
    ob, tb = t_tok.BlankOffsetTokenizer(ours), j_tok.BlankOffsetTokenizer(theirs)
    assert ob.vocab_size == tb.vocab_size
    for text in TEXTS:
        ids = tb.text_to_ids(text)
        assert ob.text_to_ids(text) == ids and ob.ids_to_text(ids) == tb.ids_to_text(ids)
    assert t_tok.DEFAULT_CHAR_LABELS == j_tok.DEFAULT_CHAR_LABELS


def _hyps_refs(seed):
    r = random.Random(seed)
    words = ["a", "speech", "model", "port", "kernel", "the", "of"]
    refs = [" ".join(r.choice(words) for _ in range(r.randint(0, 9))) for _ in range(12)]
    hyps = []
    for ref in refs:
        w = ref.split()
        for _ in range(r.randint(0, 3)):
            op = r.randrange(3)
            if op == 0 and w:
                w.pop(r.randrange(len(w)))
            elif op == 1:
                w.insert(r.randint(0, len(w)), r.choice(words))
            elif w:
                w[r.randrange(len(w))] = r.choice(words)
        hyps.append(" ".join(w))
    return hyps, refs


@pytest.mark.parametrize("seed", [0, 1])
def test_wer_tools_same(seed, tmp_path):
    hyps, refs = _hyps_refs(seed)
    for use_cer in (False, True):
        assert t_wer.error_counts(hyps, refs, use_cer) == j_wer.error_counts(hyps, refs, use_cer)
    for h, r in zip(hyps, refs):
        assert t_wer.align_words(h, r) == j_wer.align_words(h, r)
        assert t_wer.levenshtein(h, r) == j_wer.levenshtein(h, r)
    stats = [mod.render_wer_html(hyps, refs, str(tmp_path / f"{i}.html"))
             for i, mod in enumerate((t_wer, j_wer))]
    assert stats[0] == stats[1]
    assert (tmp_path / "0.html").read_text() == (tmp_path / "1.html").read_text()
    rng = np.random.default_rng(seed)
    lp = rng.standard_normal((3, 40, 6)).astype(np.float32)
    lens = np.array([40, 17, 0])
    for blank in (0, 5):
        assert (t_wer.ctc_greedy_decode(lp, lens, blank)
                == j_wer.ctc_greedy_decode(lp, lens, blank))


def _corpus(root, n=10):
    """n int16 wavs of 0.2-0.8 s with transcripts, a noise wav, manifests."""
    rng = np.random.default_rng(3)
    manifest, noise = root / "train.json", root / "noise.json"
    with open(manifest, "w") as f:
        for i in range(n):
            d = float(rng.uniform(0.2, 0.8))
            path = str(root / f"u{i}.wav")
            write_wav(path, 0.3 * rng.standard_normal(int(d * 16000)).clip(-1, 1), 16000)
            f.write(json.dumps({"audio_filepath": path, "duration": d,
                                "text": f"word {i} and more"}) + "\n")
    write_wav(str(root / "n.wav"), 0.1 * rng.standard_normal(5000), 16000)
    noise.write_text(json.dumps({"audio_filepath": str(root / "n.wav"), "duration": 0.3}) + "\n")
    return str(manifest), str(noise)


def _batches(mods, manifest, noise, text):
    data, loader, tok = mods
    aug = data.AudioAugmentor([(1.0, data.RandomNoisePerturbation(
        noise, 0.0, 30.0, ratio=0.7, rng=random.Random(11)))])
    aug.rng = random.Random(12)
    if text:
        ds = data.AudioToTextDataset(manifest, tok.CharTokenizer(), sample_rate=16000,
                                     crop_size=9000, augmentor=aug, seed=4)
        collate = data.AudioTextBatchCollate(12000, 16)
    else:
        ds = data.AudioDataset(manifest, 16000, 8000, min_duration=0.25, augmentor=aug,
                               return_both=True, seed=4)
        collate = data.AudioBatchCollate(8000)
    # one worker: the dataset's crop generator is drawn in item order
    dl = loader.DataLoader(ds, 3, collate, shuffle=True, drop_last=False, num_workers=1,
                           seed=5)
    return [b for _ in range(2) for b in dl]


@pytest.mark.parametrize("text", [False, True], ids=["pretrain", "finetune"])
def test_data_pipeline_same_batches(text, tmp_path):
    manifest, noise = _corpus(tmp_path)
    ours = _batches((t_data, t_loader, t_tok), manifest, noise, text)
    theirs = _batches((j_data, j_loader, j_tok), manifest, noise, text)
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k]
    assert t_data.read_manifest(manifest, 0.3, 0.7) == j_data.read_manifest(manifest, 0.3, 0.7)
    for i in range(3):
        w, sr = t_read_wav(str(tmp_path / f"u{i}.wav"))
        w2, sr2 = j_read_wav(str(tmp_path / f"u{i}.wav"))
        assert sr == sr2 and w.dtype == w2.dtype
        np.testing.assert_array_equal(w, w2)


TTS_TEXTS = (
    "The quick brown fox jumps over the lazy dog while the curious cat watches from a "
    "sunlit windowsill in the early morning.",
    "Dr. Smith paid $3.50 for 2 tickets on Feb. 1st, 1999, at St. John's; Mrs. Lee paid "
    "\u00a31,000,000.",
    "Say {HH AH0 L OW1} to the {W ER1 L D}, then hello again.",
    "{HH AH0 L OW1}",
    "Caf\u00e9 na\u00efve fa\u00e7ade \u2014 r\u00e9sum\u00e9 \u00fcber 42nd St.",
    "Lt. Col. Jr. ft. 10:30 (maybe) - it's a test!",
    "",
)
CMU_LINES = (";;; a small dictionary in the CMUdict format\n"
             "THE  DH AH0\nTHE(1)  DH AH1\nQUICK  K W IH1 K\nBROWN  B R AW1 N\n"
             "FOX  F AA1 K S\nHELLO  HH AH0 L OW1\nDOCTOR  D AA1 K T ER0\n"
             "TEST  T EH1 S T\nIT'S  IH1 T S\nBAD  B AE1 D XX9\nshort line\n")


@pytest.fixture
def cmu_path(tmp_path):
    path = tmp_path / "cmu_dictionary"
    path.write_text(CMU_LINES, encoding="latin-1")
    return str(path)


@pytest.mark.parametrize("with_dict", [False, True], ids=["chars", "cmudict"])
def test_text_to_sequence_and_intersperse_same(with_dict, cmu_path):
    """The TTS frontend: numbers, abbreviations, {ARPA} spans and non-ASCII
    text, with and without a dictionary (its trailing-space drop included)."""
    ours = t_text.CMUDict(cmu_path) if with_dict else None
    theirs = j_text.CMUDict(cmu_path) if with_dict else None
    if with_dict:
        assert len(ours) == len(theirs) == 8  # the entry with an unknown phone dropped
        assert ours.lookup("the") == theirs.lookup("the") == ["DH AH0", "DH AH1"]
    for text in TTS_TEXTS:
        ids = j_text.text_to_sequence(text, dictionary=theirs)
        assert t_text.text_to_sequence(text, dictionary=ours) == ids, text
        blank = len(j_text.symbols)
        assert t_text.intersperse(ids, blank) == j_text.intersperse(ids, blank)
        assert t_text.sequence_to_text(ids) == j_text.sequence_to_text(ids)
    assert t_text.symbols == j_text.symbols and len(t_text.symbols) == 148


def test_tts_cleaners_same():
    names = ("english_cleaners", "basic_cleaners", "transliteration_cleaners",
             "expand_abbreviations", "expand_numbers", "lowercase", "collapse_whitespace",
             "convert_to_ascii")
    for text in TTS_TEXTS + TEXTS:
        for name in names:
            assert getattr(t_cleaners, name)(text) == getattr(j_cleaners, name)(text), name
    with pytest.raises(ValueError, match="Unknown cleaner"):
        t_text.text_to_sequence("x", ["nope_cleaners"])


def test_write_wav_same(tmp_path):
    rng = np.random.default_rng(0)
    for wav in (rng.uniform(-1.2, 1.2, 777).astype(np.float32),
                rng.integers(-32768, 32767, 555).astype(np.int16)):
        t_write_wav(str(tmp_path / "t.wav"), wav, 22050)
        write_wav(str(tmp_path / "j.wav"), wav, 22050)
        assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()


# ---------------------------------------------------------------- DiffVC serving


def _jax_vc_cli(monkeypatch):
    """The JAX package's cli/inference_vc.py, which imports params_vc from
    its own directory."""
    monkeypatch.syspath_prepend(os.path.join(REPO, "cli"))
    import inference_vc
    import params_vc

    return inference_vc, params_vc


def test_diffvc_config_copy_equals_cli_params_vc(monkeypatch):
    from tpu_speech_torch.configs import diffvc as t_params

    _, theirs = _jax_vc_cli(monkeypatch)
    names = [n for n in vars(theirs) if not n.startswith("_")]
    assert len(names) == 20
    for n in names:
        assert getattr(t_params, n) == getattr(theirs, n), n


def _vc_wav(seed, seconds, sr):
    rng = np.random.default_rng(seed)
    n = int(sr * seconds)
    t = np.arange(n) / sr
    y = sum(np.sin(2 * np.pi * 150 * h * t + rng.uniform(0, 6)) / h for h in range(1, 10))
    y *= (1 + np.sin(2 * np.pi * 2.5 * t)) ** 2  # syllables
    y[n // 3: n // 2] = 0  # a long pause for the silence trim
    return (0.1 * y / np.abs(y).max() + 1e-4 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("sr", [22050, 16000], ids=["resampled", "16k"])
def test_speaker_frontend_same(sr):
    """preprocess_wav (scipy resample_poly, volume, silence trim),
    trim_long_silences, wav_to_mel_spectrogram and compute_partial_slices,
    the port's copies against the JAX package's, equal."""
    from tpu_speech.models import speaker_encoder as j_spk
    from tpu_speech_torch.models import speaker_encoder as t_spk

    wav = _vc_wav(sr, 2.7, sr)
    pre_t, pre_j = t_spk.preprocess_wav(wav, source_sr=sr), j_spk.preprocess_wav(wav, sr)
    assert pre_t.dtype == pre_j.dtype and len(pre_t) < len(wav) * 16000 / sr
    np.testing.assert_array_equal(pre_t, pre_j)
    np.testing.assert_array_equal(t_spk.trim_long_silences(wav), j_spk.trim_long_silences(wav))
    np.testing.assert_array_equal(t_spk.normalize_volume(wav), j_spk.normalize_volume(wav))
    np.testing.assert_array_equal(t_spk.wav_to_mel_spectrogram(pre_t),
                                  j_spk.wav_to_mel_spectrogram(pre_j))
    for n in (0, 100, 1600 * 10, len(pre_t), 16000 * 7 + 3):
        assert t_spk.compute_partial_slices(n) == j_spk.compute_partial_slices(n), n


def test_vc_denoiser_same(monkeypatch, tmp_path):
    """noise_median_smoothing and mel_spectral_subtraction (host numpy, the
    notebook's denoiser), the port's CLI against the JAX CLI, equal."""
    from tpu_speech_torch.cli import inference_vc as t_cli

    j_cli, _ = _jax_vc_cli(monkeypatch)
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, 80).astype(np.float32)
    for w in (1, 5):
        np.testing.assert_array_equal(t_cli.noise_median_smoothing(x, w),
                                      j_cli.noise_median_smoothing(x, w))
    src = rng.normal(-4, 2, (90, 80)).astype(np.float32)
    src[30:37] = -11.0
    synth = rng.normal(-5, 2, (90, 80)).astype(np.float32)
    for sw in (1, None):
        np.testing.assert_array_equal(
            t_cli.mel_spectral_subtraction(synth, src, smoothing_window=sw),
            j_cli.mel_spectral_subtraction(synth, src, smoothing_window=sw))
    wav = _vc_wav(5, 1.3, 22050)
    path = str(tmp_path / "vc.wav")
    write_wav(path, wav, 22050)
    np.testing.assert_array_equal(t_cli.get_mel(path), j_cli.get_mel(path))


# ---------------------------------------------------------------- DiffVC and GE2E training

TEXTGRID = """File type = "ooTextFile"
Object class = "TextGrid"

xmin = 0
xmax = {xmax}
tiers? <exists>
size = 2
item []:
    item [1]:
        class = "IntervalTier"
        name = "words"
        xmin = 0
        xmax = {xmax}
        intervals: size = 1
        intervals [1]:
            xmin = 0
            xmax = {xmax}
            text = "word"
    item [2]:
        class = "IntervalTier"
        name = "phones"
        xmin = 0
        xmax = {xmax}
        intervals: size = {n}
{items}"""


def _write_textgrid(path, phones, xmax):
    edges = np.linspace(0, xmax, len(phones) + 1)
    items = "".join(f"        intervals [{i + 1}]:\n            xmin = {edges[i]:.4f}\n"
                    f"            xmax = {edges[i + 1]:.4f}\n            text = \"{p}\"\n"
                    for i, p in enumerate(phones))
    with open(path, "w") as f:
        f.write(TEXTGRID.format(xmax=xmax, n=len(phones), items=items))


def _vc_tree(root, rng, speakers=("p225", "p252", "s1"), n_utts=11):
    """A DiffVC data dir: mels (80, T), embeddings and TextGrids; VCTK-like
    ids '<spk>_<sentence>', one utterance per speaker with an 'spn' phone."""
    phones = ["sil", "AH0", "S", "IY1", "T"]
    for spk in speakers:
        for d in ("mels", "embeds", "textgrids"):
            os.makedirs(os.path.join(root, d, spk), exist_ok=True)
        for u in range(n_utts):
            uid = f"{spk}_{u + 1:03d}"
            t = int(rng.integers(40, 90))
            mel = np.round(rng.normal(-5, 2, (80, t)), 1).astype(np.float32)
            np.save(os.path.join(root, "mels", spk, f"{uid}_mel.npy"), mel)
            np.save(os.path.join(root, "embeds", spk, f"{uid}_embed.npy"),
                    rng.standard_normal(256).astype(np.float32))
            ph = list(rng.choice(phones, size=6)) + (["spn"] if u == 2 else [])
            _write_textgrid(os.path.join(root, "textgrids", spk, f"{uid}.TextGrid"), ph,
                            t * 256 / 22050)
    return root


def test_textgrid_reader_same(tmp_path):
    from tpu_speech.data import textgrid as j_tg
    from tpu_speech_torch.data import textgrid as t_tg

    path = str(tmp_path / "a.TextGrid")
    _write_textgrid(path, ["sil", "AH0", "spn", "T"], 0.73)
    for tier in ("phones", "words"):
        assert t_tg.get_tier(path, tier) == [t_tg.Interval(iv.start_time, iv.end_time, iv.text)
                                            for iv in j_tg.get_tier(path, tier)]
    assert t_tg.has_phone(path) and j_tg.has_phone(path)
    assert t_tg.has_phone(str(tmp_path / "absent")) == j_tg.has_phone(str(tmp_path / "absent"))
    with pytest.raises(KeyError):
        t_tg.get_tier(path, "syllables")


def test_diffvc_data_pipeline_same(tmp_path):
    """VCEncDataset (the 'spn' filter, exclusions), VCDecDataset (the
    speakers with enough utterances, a validation file), their collates'
    crops, and the VCTK variants: the same order, items and batches."""
    from tpu_speech.data import diffvc as j_vc
    from tpu_speech_torch.data import diffvc as t_vc

    root = _vc_tree(str(tmp_path), np.random.default_rng(0))
    os.makedirs(os.path.join(root, "mels_mode"), exist_ok=True)
    for spk in os.listdir(os.path.join(root, "mels")):
        shutil.copytree(os.path.join(root, "mels", spk), os.path.join(root, "mels_mode", spk))
        for name in os.listdir(os.path.join(root, "mels_mode", spk)):
            base = os.path.join(root, "mels_mode", spk, name)
            os.rename(base, base.replace("_mel.npy", "_avgmel.npy"))
    exc = str(tmp_path / "exc.txt")
    with open(exc, "w") as f:
        f.write("p225_004\ns1_007\n")
    pairs = [
        (t_vc.VCEncDataset(root, exc), j_vc.VCEncDataset(root, exc)),
        (t_vc.VCDecDataset(root, exc, exc), j_vc.VCDecDataset(root, exc, exc)),
        (t_vc.VCDecDataset(root, min_utts_per_speaker=12),
         j_vc.VCDecDataset(root, min_utts_per_speaker=12)),
        (t_vc.VCTKEncDataset(root), j_vc.VCTKEncDataset(root)),
        (t_vc.VCTKDecDataset(root), j_vc.VCTKDecDataset(root)),
    ]
    for ours, theirs in pairs:
        assert ours.train_info == theirs.train_info
        assert len(ours) == len(theirs)
    assert len(pairs[0][0]) == 3 * 11 - 3 - 2  # an 'spn' utterance per speaker, 2 excluded
    assert len(pairs[2][0]) == 0 and pairs[1][0].valid_info == pairs[1][1].valid_info
    for (ours, theirs), cls in ((pairs[0], "VCEncBatchCollate"), (pairs[1], "VCDecBatchCollate")):
        ct, cj = getattr(t_vc, cls)(64, 80, seed=5), getattr(j_vc, cls)(64, 80, seed=5)
        for start in (0, 6):
            idx = range(start, start + 6)
            bt = ct([ours[i] for i in idx])
            bj = cj([theirs[i] for i in idx])
            assert bt.keys() == bj.keys()
            for k in bt:
                assert bt[k].dtype == bj[k].dtype, k
                np.testing.assert_array_equal(bt[k], bj[k])


def test_build_average_mels_same(tmp_path):
    """Per-phoneme medians, their corpus mode and the painted targets:
    equal, file for file."""
    from tpu_speech.data import diffvc as j_vc
    from tpu_speech_torch.data import diffvc as t_vc

    root = _vc_tree(str(tmp_path), np.random.default_rng(1), n_utts=4)
    modes_t = t_vc.build_average_mels(root, avg_type="t")
    modes_j = j_vc.build_average_mels(root, avg_type="j")
    assert sorted(modes_t) == sorted(modes_j)
    for ph in modes_t:
        np.testing.assert_array_equal(modes_t[ph], modes_j[ph])
    for spk in os.listdir(os.path.join(root, "mels_t")):
        names = sorted(os.listdir(os.path.join(root, "mels_t", spk)))
        assert names == sorted(os.listdir(os.path.join(root, "mels_j", spk))) and names
        for name in names:
            np.testing.assert_array_equal(np.load(os.path.join(root, "mels_t", spk, name)),
                                          np.load(os.path.join(root, "mels_j", spk, name)))


def test_random_cycler_same():
    """RandomCycler's bounded-starvation order, the same generator seed:
    the same items (all of them at least count // n times)."""
    from tpu_speech.data.speaker_verification import RandomCycler as JCycler
    from tpu_speech_torch.data.speaker_verification import RandomCycler as TCycler

    items = list("abcdefg")
    ours, theirs = (c(items, np.random.default_rng(4)) for c in (TCycler, JCycler))
    for count in (3, 7, 5, 16, 1, 9):
        got = ours.sample(count)
        assert got == theirs.sample(count)
        assert min(got.count(i) for i in items) >= count // len(items)
    with pytest.raises(ValueError, match="empty"):
        TCycler([], np.random.default_rng(0))


def test_pca_project_same():
    from tpu_speech.utils.plotting import pca_project as j_pca
    from tpu_speech_torch.utils.plotting import pca_project as t_pca

    x = np.random.default_rng(2).standard_normal((30, 12)).astype(np.float32)
    for k in (2, 3):
        np.testing.assert_array_equal(t_pca(x, k), j_pca(x, k))


def test_read_audio_same(tmp_path):
    """A wav reads natively, alike; a compressed file goes through the
    host's decoder, or, without one, raises alike."""
    from tpu_speech.data.wav import read_audio as j_read
    from tpu_speech_torch.data.wav import read_audio as t_read

    wav = _vc_wav(3, 0.4, 22050)
    path = str(tmp_path / "a.WAV")
    write_wav(path, wav, 22050)
    (a, sr_a), (b, sr_b) = t_read(path), j_read(path)
    assert sr_a == sr_b == 22050
    np.testing.assert_array_equal(a, b)
    bogus = str(tmp_path / "b.flac")
    with open(bogus, "wb") as f:
        f.write(b"not audio")
    outcomes = []
    for read in (t_read, j_read):
        try:
            outcomes.append(("ok", read(bogus)[1]))
        except RuntimeError as e:
            outcomes.append(("raised", str(e)))
    assert outcomes[0] == outcomes[1]


def test_preprocess_speaker_dirs_same(tmp_path, monkeypatch):
    """cli/preprocess_spk.py::preprocess_speaker_dirs, the port's CLI
    against the JAX CLI on the same tree: the same files, frames and
    sources (the log's timestamps aside)."""
    monkeypatch.syspath_prepend(os.path.join(REPO, "cli"))
    import preprocess_spk as j_cli
    from tpu_speech_torch.cli import preprocess_spk as t_cli

    raw = tmp_path / "raw"
    for s, f0 in enumerate((120.0, 210.0)):
        (raw / f"spk{s}" / "ch1").mkdir(parents=True)
        for u in range(2):
            write_wav(str(raw / f"spk{s}" / "ch1" / f"u{u}.wav"), _vc_wav(s * 2 + u, 1.9, 22050),
                      22050)
    write_wav(str(raw / "spk1" / "tiny.wav"), _vc_wav(9, 0.3, 16000), 16000)
    n_t = t_cli.preprocess_speaker_dirs(str(raw), str(tmp_path / "t"), "toy")
    n_j = j_cli.preprocess_speaker_dirs(str(raw), str(tmp_path / "j"), "toy")
    assert n_t == n_j == 4
    for spk in ("spk0", "spk1"):
        names = sorted(os.listdir(tmp_path / "t" / spk))
        assert names == sorted(os.listdir(tmp_path / "j" / spk))
        for name in names:
            a, b = tmp_path / "t" / spk / name, tmp_path / "j" / spk / name
            if name.endswith(".npy"):
                np.testing.assert_array_equal(np.load(a), np.load(b))
            else:
                assert a.read_text() == b.read_text()
    stats = [[ln for ln in (tmp_path / d / "Log_toy.txt").read_text().splitlines()
              if ln.startswith("\t")] for d in ("t", "j")]
    assert stats[0] == stats[1] and stats[0]


def test_hifigan_data_pipeline_same(tmp_path):
    """load_wav_files (ids and paths, text past '|' ignored, blank lines),
    MelAudioDataset (peak normalisation, crops from its seeded generator,
    zero-padding of short wavs, fine-tuning mels stored (T, n_mels) and
    (n_mels, T), split off) and MelAudioBatchCollate: the same files, items
    and batches; the same errors."""
    from tpu_speech.data import hifigan as j_hifi
    from tpu_speech_torch.data import hifigan as t_hifi

    rng = np.random.default_rng(4)
    hop, seg, names = 16, 256, []
    for i, length in enumerate((700, 256, 100, 513)):
        write_wav(str(tmp_path / f"u{i}.wav"),
                  (0.4 * rng.standard_normal(length)).astype(np.float32), 1600)
        names.append(f"u{i}")
    flist = tmp_path / "list.txt"
    flist.write_text(f"{names[0]}|a text\n\n{names[1]}.wav\n{names[2]}|x|y\n{names[3]}\n")
    files = t_hifi.load_wav_files(str(flist), str(tmp_path))
    assert files == j_hifi.load_wav_files(str(flist), str(tmp_path))
    assert t_hifi.load_wav_files(str(flist)) == j_hifi.load_wav_files(str(flist))
    mels = tmp_path / "mels"
    mels.mkdir()
    for i, n in enumerate(names):
        frames = (700, 256, 100, 513)[i] // hop + 4  # T > n_mels: stored either way
        mel = rng.standard_normal((frames, 8)).astype(np.float32)
        np.save(mels / f"{n}.npy", mel.T if i % 2 else mel)  # (n_mels, T) for two of them
    for kw in (dict(), dict(seed=9), dict(split=False),
               dict(fine_tuning=True, input_mels_dir=str(mels)),
               dict(fine_tuning=True, input_mels_dir=str(mels), split=False)):
        kw = dict(dict(segment_size=seg, sampling_rate=1600, hop_size=hop), **kw)
        ours, theirs = t_hifi.MelAudioDataset(files, **kw), j_hifi.MelAudioDataset(files, **kw)
        assert len(ours) == len(theirs) == 4
        for i in (0, 3, 2, 0, 1, 3):  # the generator advances alike
            a, b = ours[i], theirs[i]
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k])
        if kw.get("split", True):
            bt = t_hifi.MelAudioBatchCollate()([ours[i] for i in range(4)])
            bj = j_hifi.MelAudioBatchCollate()([theirs[i] for i in range(4)])
            assert bt.keys() == bj.keys()
            for k in bt:
                np.testing.assert_array_equal(bt[k], bj[k])
    for bad in (dict(fine_tuning=True), dict(segment_size=250), dict(sampling_rate=22050)):
        kw = dict(dict(segment_size=seg, sampling_rate=1600, hop_size=hop), **bad)
        errors = []
        for mod in (t_hifi, j_hifi):
            with pytest.raises(ValueError) as e:
                mod.MelAudioDataset(files, **kw)[0]
            errors.append(str(e.value))
        assert errors[0] == errors[1]


@pytest.mark.parametrize("eta,window_size", [(0.15, 0), (0.0, 0), (0.15, 321)],
                         ids=["default", "frozen-profile", "odd-window"])
def test_logmmse_same(eta, window_size):
    """``audio/logmmse.py``'s copy: ``profile_noise`` and ``denoise`` equal
    the JAX package's on the same numpy input (a tone under noise, a noise
    clip), bit for bit; a clip shorter than a window raises alike."""
    from tpu_speech.audio import logmmse as j_lm
    from tpu_speech_torch.audio import logmmse as t_lm

    sr = 16000
    rng = np.random.default_rng(3)
    t = np.arange(sr) / sr
    noise = 0.2 * rng.standard_normal(sr)
    noisy = (0.5 * np.sin(2 * np.pi * 440 * t) + noise).astype(np.float32)
    ours, theirs = (m.profile_noise(noise[: sr // 2], sr, window_size) for m in (t_lm, j_lm))
    for f in ("sampling_rate", "window_size", "len1", "len2", "n_fft"):
        assert getattr(ours, f) == getattr(theirs, f)
    for f in ("win", "noise_mu2"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(theirs, f))
    a, b = t_lm.denoise(noisy, ours, eta), j_lm.denoise(noisy, theirs, eta)
    assert a.dtype == b.dtype == np.float32 and a.shape == noisy.shape
    np.testing.assert_array_equal(a, b)
    for m in (t_lm, j_lm):
        with pytest.raises(ValueError, match="shorter than one analysis window"):
            m.profile_noise(noise[:100], sr)


@pytest.mark.parametrize("length,d_model", [(1, 4), (7, 16), (604, 176)])
def test_rel_positional_encoding_same(length, d_model):
    """``nn/conformer_attention.py::rel_positional_encoding``'s numpy copy:
    bit for bit, at the Conformer-CTC small width and frames too."""
    from tpu_speech.nn.conformer_attention import rel_positional_encoding as j_pe
    from tpu_speech_torch.nn.conformer_attention import rel_positional_encoding as t_pe

    np.testing.assert_array_equal(t_pe(length, d_model), j_pe(length, d_model))


@pytest.mark.parametrize("n_mfcc,nfilt", [(13, 40), (64, 64)])
def test_mfcc_dct_same(n_mfcc, nfilt, monkeypatch):
    """``augment.py::dct_matrix``, the copy of ``mfcc_features``'s DCT-II:
    JAX's ``mfcc_features`` on identity "log-mel" rows gives its DCT (the
    featurizer stubbed), which must equal the port's in float32."""
    import jax.numpy as jnp

    from tpu_speech.models.spiral import augment as j_aug
    from tpu_speech.models.spiral import features as j_feat
    from tpu_speech_torch.models.spiral.augment import dct_matrix

    monkeypatch.setattr(j_feat, "filterbank_features",
                        lambda x, lens, **kw: (jnp.eye(nfilt)[None], lens))
    dct_t, _ = j_aug.mfcc_features(jnp.zeros((1, 10)), jnp.array([10]), n_mfcc=n_mfcc)
    np.testing.assert_array_equal(dct_matrix(n_mfcc, nfilt).T.astype(np.float32),
                                  np.asarray(dct_t[0]))


def test_librispeech_build_manifest_same(tmp_path):
    """``cli/get_librispeech_data.py::build_manifest``'s copy, in process on
    one split of a synthetic tree (wavs made beforehand, an undecodable
    flac): the same manifest bytes."""
    import importlib.util

    from tests.test_torch_librispeech_data import write_tree
    from tpu_speech_torch.cli import get_librispeech_data as t_ls

    spec = importlib.util.spec_from_file_location(
        "jax_get_librispeech_data", os.path.join(REPO, "cli", "get_librispeech_data.py"))
    j_ls = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(j_ls)
    root = str(tmp_path)
    write_tree(root)
    split_dir = os.path.join(root, "LibriSpeech", "dev-clean")
    wav_dir = os.path.join(root, "wavs", "dev-clean")
    j_ls.build_manifest(split_dir, wav_dir, os.path.join(root, "j.json"))
    assert t_ls.build_manifest(split_dir, wav_dir, os.path.join(root, "t.json")) == 11
    with open(os.path.join(root, "j.json")) as a, open(os.path.join(root, "t.json")) as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("size", [2, 4, 8])
def test_fsdp_shardings_rule_same(size):
    """``parallel/mesh.py::fsdp_shardings``' choice of dimension against its
    original (``tpu_speech/parallel/mesh.py:146``) on leaves of every kind:
    ties (the first largest dimension), dimensions the data size does not
    divide, the 2**14 threshold, scalars and vectors."""
    import jax

    from tpu_speech.parallel import mesh as j_mesh
    from tpu_speech_torch.parallel import mesh as t_mesh

    shapes = [(), (7,), (2 ** 14,), (2 ** 14 + 2,), (128, 128), (96, 256), (256, 96), (3, 6001),
              (5, 8, 1024), (1024, 8, 5), (64, 64, 4), (127, 129), (16384, 1), (40, 410)]
    tree = {f"l{i}": np.zeros(s, np.float32) for i, s in enumerate(shapes)}
    j_specs = j_mesh.fsdp_shardings(j_mesh.make_mesh(n_devices=size), tree)
    got = t_mesh.fsdp_shardings(size, tree.items())
    for k, spec in j_specs.items():
        dims = [i for i, p in enumerate(spec.spec) if p is not None]
        want = dims[0] if dims else t_mesh.REPLICATED
        assert (got[k] if got[k] == t_mesh.REPLICATED else got[k].dim) == want, (k, tree[k].shape)
    assert jax.device_count() >= size



# ---- SPIRAL's data options: tar shards, duration buckets, the mu-law wire ------

def _tar_corpus(root, n=10):
    """``_corpus``'s wavs in three tar shards (a directory and a member the
    manifest does not name among them)."""
    import tarfile

    manifest, noise = _corpus(root, n)
    tars = []
    for k in range(3):
        path = str(root / f"shard{k}.tar")
        with tarfile.open(path, "w") as tf:
            if k == 0:
                (root / "sub").mkdir(exist_ok=True)
                tf.add(str(root / "sub"), arcname="sub")
                tf.add(str(root / "n.wav"), arcname="unlisted.wav")
            for i in range(k, n, 3):
                tf.add(str(root / f"u{i}.wav"), arcname=f"audio/u{i}.wav")
        tars.append(path)
    return manifest, noise, ",".join(tars)


def _tar_batches(mods, manifest, noise, tars, text, shard_id, num_shards, shuffle_n):
    data, tok = mods
    aug = data.AudioAugmentor([(1.0, data.RandomNoisePerturbation(
        noise, 0.0, 30.0, ratio=0.7, rng=random.Random(11)))])
    aug.rng = random.Random(12)
    kw = dict(crop_size=7000, shuffle_n=shuffle_n, seed=2, shard_id=shard_id,
              num_shards=num_shards, augmentor=aug)
    if text:
        ds = data.TarredAudioDataset(manifest, tars, 16000, tokenizer=tok.CharTokenizer(), **kw)
        collate = data.AudioTextBatchCollate(7000, 16)
    else:
        ds = data.TarredAudioDataset(manifest, tars, 16000, return_both=True, **kw)
        collate = data.AudioBatchCollate(7000)
    return len(ds), [b for _ in range(2) for b in ds.iter_batches(2, collate, drop_last=False)]


def _assert_batches_equal(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k], k


@pytest.mark.parametrize("text", [False, True], ids=["pretrain", "finetune"])
@pytest.mark.parametrize("num_shards,shuffle_n", [(1, 0), (2, 3)])
def test_tarred_batches_same(text, num_shards, shuffle_n, tmp_path):
    """``TarredAudioDataset`` over three tar shards, each of ``num_shards``
    data ranks its shards, the crops, the noise, the labels and the
    ``shuffle_n`` reservoir drawn from ``seed + shard_id``: two epochs of
    batches equal JAX's, and so is the length."""
    manifest, noise, tars = _tar_corpus(tmp_path)
    for shard_id in range(num_shards):
        args = (manifest, noise, tars, text, shard_id, num_shards, shuffle_n)
        n_ours, ours = _tar_batches((t_data, t_tok), *args)
        n_theirs, theirs = _tar_batches((j_data, j_tok), *args)
        assert n_ours == n_theirs
        _assert_batches_equal(ours, theirs)


def _jax_bucket_bounds(durations, max_samples, sr, num_buckets):
    """The JAX finetune runner's bounds (``spiral_runner.py:656-670``)."""
    qs = np.quantile(durations, np.arange(1, num_buckets + 1) / num_buckets)
    max_dur = max_samples / sr
    bounds = sorted(set(min(max_dur, float(np.ceil(q * 4.0) / 4.0)) for q in qs))
    bounds[-1] = max_dur
    return bounds


def _jax_bucket_collate(bound_samples, max_samples):
    """The JAX finetune runner's collate builder (``spiral_runner.py:672-675``)."""
    cap = -(-512 * bound_samples // max_samples)
    labels = max(64, (cap + 31) // 32 * 32)
    return j_data.AudioTextBatchCollate(bound_samples, int(labels))


@pytest.mark.parametrize("run_length", [1, 2])
def test_bucketed_batches_same(run_length, tmp_path):
    """``BucketedDataLoader`` with the finetune runner's quantile bounds
    and per-bucket collates over two data ranks: the same bounds, and two
    epochs of each rank's batches equal JAX's bit for bit; each batch is
    padded to its bucket's bound, and runs of ``run_length`` share one."""
    from tpu_speech_torch.train.spiral_runner import bucket_bounds, bucket_collate

    manifest, _ = _corpus(tmp_path, n=24)
    max_samples = 16000
    durations = [e["duration"] for e in t_data.read_manifest(manifest)]
    bounds = bucket_bounds(durations, max_samples, 16000, 4)
    assert bounds == _jax_bucket_bounds(np.asarray(durations), max_samples, 16000, 4)
    assert len(bounds) > 1
    for shard_id in range(2):
        loaders = []
        for data, loader, tok, collate in (
                (t_data, t_loader, t_tok, lambda b: bucket_collate(b, max_samples)),
                (j_data, j_loader, j_tok, lambda b: _jax_bucket_collate(b, max_samples))):
            ds = data.AudioToTextDataset(manifest, tok.CharTokenizer(), sample_rate=16000,
                                         crop_size=max_samples, seed=4)
            loaders.append(loader.BucketedDataLoader(
                ds, 2, collate, durations, bounds, 16000, run_length=run_length,
                num_workers=1, seed=5, shard_id=shard_id, num_shards=2))
        ours, theirs = ([b for _ in range(2) for b in dl] for dl in loaders)
        _assert_batches_equal(ours, theirs)
        widths = [b["wavs"].shape[1] for b in ours]
        assert set(widths) <= {int(round(b * 16000)) for b in bounds}
        for i in range(0, len(widths) // 2, run_length):  # the first epoch's runs
            assert len(set(widths[i:i + run_length])) == 1


def test_mulaw_wire_bytes_same():
    """``quantize_wire_mulaw``' bytes (clipped tails, zeros, the extremes)
    and ``quantize_wire``'s dispatch equal JAX's; an unknown wire fails
    alike."""
    from tpu_speech.train import spiral as j_spiral
    from tpu_speech_torch.train import spiral as t_spiral

    rng = np.random.default_rng(0)
    wavs = (rng.standard_normal((3, 4000)) * 0.4).astype(np.float32)
    wavs[0, :5] = [0.0, 1.0, -1.0, 1.7, -3.0]
    batch = {"wavs": wavs, "p_wavs": wavs[::-1].copy(), "wav_lens": np.full(3, 4000, np.int32)}
    for wire in ("mulaw", "int16", "float32"):
        ours, theirs = t_spiral.quantize_wire(batch, wire), j_spiral.quantize_wire(batch, wire)
        for k in batch:
            assert ours[k].dtype == theirs[k].dtype
            assert ours[k].tobytes() == theirs[k].tobytes(), (wire, k)
    mu = t_spiral.quantize_wire_mulaw(batch)
    assert mu["wavs"].dtype == np.uint8 and mu["wavs"].tobytes() == \
        j_spiral.quantize_wire_mulaw(batch)["wavs"].tobytes()
    for mod in (t_spiral, j_spiral):
        with pytest.raises(ValueError, match="expected float32/int16/mulaw"):
            mod.quantize_wire(batch, "bf16")


def _runner_corpus(root, n, seconds=(0.3, 1.0)):
    rng = np.random.default_rng(1)
    path = root / "train.json"
    with open(path, "w") as f:
        for i in range(n):
            d = float(np.round(rng.uniform(*seconds), 3))
            wav = str(root / f"r{i}.wav")
            t_write_wav(wav, (0.2 * rng.standard_normal(int(d * 16000))).clip(-1, 1), 16000)
            f.write(json.dumps({"audio_filepath": wav, "duration": d,
                                "text": "ab c" if i % 2 else "hi"}) + "\n")
    return str(path)


def _tar_of(root, manifest):
    import tarfile

    path = str(root / "train.tar")
    with tarfile.open(path, "w") as tf:
        for e in t_data.read_manifest(manifest):
            tf.add(e["audio_filepath"], arcname=os.path.basename(e["audio_filepath"]))
    return path


@pytest.fixture(scope="module")
def _runner_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("option", ["tarred", "buckets_accum2", "buckets_bf16", "mulaw"])
def test_finetune_runner_epoch_on_each_data_option(option, tmp_path, _runner_threads):
    """The tiny finetune runner trains an epoch with tarred data, with four
    duration buckets at ``accumulate_grad_batches`` 2 and in bf16, and on
    the mu-law wire: finite losses; the buckets' steps see their bounds'
    widths, a new width between updates, never two in one update; the
    mu-law batches travel as uint8. Tarred data with buckets fails as JAX's
    runner does."""
    import torch

    from tpu_speech_torch.configs.spiral import spiral_tiny_ctc_char
    from tpu_speech_torch.text.tokenizers import CharTokenizer
    from tpu_speech_torch.train.spiral_runner import SpiralFinetuneRunner

    cfg = spiral_tiny_ctc_char()
    ds = cfg.model.train_ds
    ds.manifest_filepath = _runner_corpus(tmp_path, 16)
    ds.num_workers = 1
    if option == "tarred":
        ds.tarred_audio_filepaths = _tar_of(tmp_path, ds.manifest_filepath)
        ds.shuffle_n = 4
    elif option.startswith("buckets"):
        ds.num_buckets = 4
        if option == "buckets_accum2":
            cfg.trainer.accumulate_grad_batches = 2
        else:
            cfg.model.precision = "bf16"
    else:
        ds.wire_dtype = "mulaw"
    runner = SpiralFinetuneRunner(cfg, str(tmp_path / "run"), CharTokenizer(), device="cpu")
    seen, step = [], runner.step

    def recording(batch):
        seen.append([tuple(b["wavs"].shape) + (b["wavs"].dtype,)
                     for b in (batch if isinstance(batch, list) else [batch])])
        return step(batch)

    runner.step = recording
    loss = runner.train_epoch(1)
    assert np.isfinite(loss) and runner.iteration == len(seen) > 0
    if option == "tarred":
        assert len(runner.loader) == 8 and runner.iteration == 8
        assert all(s[0][1] == 16000 for s in seen)
        cfg.model.train_ds.num_buckets = 2
        with pytest.raises(ValueError, match="tarred shards stream in order"):
            SpiralFinetuneRunner(cfg, str(tmp_path / "run2"), CharTokenizer(),
                                 device="cpu").loader
    elif option.startswith("buckets"):
        widths = [[w for w, *_ in ((s[1],) for s in update)] for update in seen]
        per_update = 2 if option == "buckets_accum2" else 1
        assert all(len(u) == per_update and len(set(u)) == 1 for u in widths)
        assert any(a[0] != b[0] for a, b in zip(widths, widths[1:]))
        bounds = {int(round(b * 16000)) for b in runner.loader.bounds}
        assert {u[0] for u in widths} <= bounds
    else:
        assert all(s[0][2] == torch.uint8 for s in seen)


@pytest.mark.parametrize("option", ["tarred", "mulaw"])
def test_pretrain_runner_epoch_on_each_data_option(option, tmp_path, _runner_threads):
    """The tiny pretrain runner trains an epoch from a tar shard and on the
    mu-law wire: finite losses, uint8 waves on the mu-law wire."""
    import torch

    from tpu_speech_torch.configs.spiral import spiral_tiny_pretrain
    from tpu_speech_torch.train.spiral_runner import SpiralPretrainRunner

    cfg = spiral_tiny_pretrain()
    ds = cfg.model.train_ds
    ds.manifest_filepath = _runner_corpus(tmp_path, 8, seconds=(1.05, 1.4))
    ds.max_duration = 2.0
    ds.num_workers = 1
    if option == "tarred":
        ds.tarred_audio_filepaths = _tar_of(tmp_path, ds.manifest_filepath)
    else:
        ds.wire_dtype = "mulaw"
    runner = SpiralPretrainRunner(cfg, str(tmp_path / "run"), device="cpu")
    seen, step = [], runner.step
    runner.step = lambda batch: (seen.append(batch["wavs"].dtype), step(batch))[1]
    loss = runner.train_epoch(1)
    assert np.isfinite(loss) and runner.iteration == len(seen) == 4
    assert set(seen) == {torch.uint8 if option == "mulaw" else torch.int16}
