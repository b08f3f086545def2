"""SPIRAL CTC runner, inference half: build, load weights, transcribe, test.

Port of the serving subset of
``tpu_speech/train/spiral_runner.py::SpiralFinetuneRunner``: the model built
from the run config (``:692-705``), weight loading, ``_infer_fn:1098``
(wav -> ``wav_to_spec`` -> ``CTCFinetuneModel`` -> log-probs),
``transcribe:961`` (with the overlapping-window path for audio longer than
``max_duration``) and ``evaluate:1134`` (greedy CTC decode, WER/CER and the
per-utterance HTML diagnosis). Host-side data, tokenizers and scoring are the
JAX package's own JAX-free modules.

The serving path runs in full float32: ``use_full_fp32()`` turns TF32 off
for both cuDNN convolutions (on by default in PyTorch) and matmuls.

Not ported yet: the training methods (``train_epoch``, ``validate``,
checkpoint resume and archives), beam search and streaming decode;
multi-process evaluation.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from tpu_speech.data.loader import DataLoader
from tpu_speech.data.spiral import AudioTextBatchCollate, AudioToTextDataset
from tpu_speech.data.wav import read_wav
from tpu_speech.eval.wer import ctc_greedy_decode, error_counts, render_wer_html
from tpu_speech.text.tokenizers import BlankOffsetTokenizer
from tpu_speech_torch.compat.jax_spiral import ctc_finetune_from_jax, load_jax_npz
from tpu_speech_torch.models.spiral.ctc import CTCFinetuneModel
from tpu_speech_torch.models.spiral.st2vec import wav_to_spec

# reference-checkpoint buffers that are constants here (the JAX converter
# drops them the same way, compat/torch_spiral.py:200-204)
_REFERENCE_CONSTANTS = ("encoder.mask_emb", "encoder.wav2spec.featurizer.window",
                        "encoder.wav2spec.featurizer.fb")


def use_full_fp32() -> None:
    """fp32 serving: PyTorch runs cuDNN convolutions in TF32 by default
    (``torch.backends.cudnn.allow_tf32 = True``), which keeps ~3 decimal
    digits; the reference path is full fp32, so TF32 goes off for
    convolutions and matmuls alike."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def build_model(cfg, num_classes: int, device=None) -> CTCFinetuneModel:
    """CTCFinetuneModel from ``cfg.model`` (encoder + decoder configs)."""
    m = cfg.model
    dec = m.decoder
    kw = {}
    blank_pos = "vocab_first"
    if dec is not None:
        blank_pos = dec.blank_pos
        if dec.conv_layers is not None:
            kw["decoder_convs"] = tuple(dec.conv_layers)
        kw.update(upsample_rate=dec.upsample_rate,
                  upsample_filters=dec.upsample_filters,
                  upsample_norm=dec.upsample_norm,
                  upsample_act=dec.upsample_act,
                  upsample_dropout=dec.upsample_dropout)
    return CTCFinetuneModel(m.encoder, num_classes, blank_pos, device=device, **kw)


def load_state_dict_file(path: str):
    """A torch state_dict (``.pt``/``.pth``/``.ckpt``; a Lightning checkpoint's
    ``state_dict`` is unwrapped) or JAX trees in an ``.npz``."""
    if path.endswith(".npz"):
        return ctc_finetune_from_jax(*load_jax_npz(path))
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd and not torch.is_tensor(sd["state_dict"]):
        sd = sd["state_dict"]
    return {k: v for k, v in sd.items() if k not in _REFERENCE_CONSTANTS}


class SpiralFinetuneRunner:
    """Serving half of the JAX SpiralFinetuneRunner; the training methods
    come with the port of the finetune step."""

    def __init__(self, cfg, log_dir: str, tokenizer, device=None):
        self.cfg = cfg
        m = cfg.model
        self.enc_cfg = m.encoder
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.device = torch.device(
            device or ("cuda" if torch.cuda.is_available() else "cpu"))
        if self.device.type == "cuda":
            use_full_fp32()
        dec = m.decoder
        if dec is None or dec.blank_pos == "vocab_first":
            # reserve id 0 for the CTC blank (blank_pos='vocab_first')
            tokenizer = BlankOffsetTokenizer(tokenizer)
        self.tokenizer = tokenizer
        self.sample_rate = m.train_ds.sample_rate
        self.max_samples = int((m.train_ds.max_duration or 24.0) * self.sample_rate)
        # random weights from a seeded generator until load_* replaces them
        # (the JAX runner's model.init with PRNGKey(0))
        model = build_model(cfg, tokenizer.vocab_size)
        model.init_weights(torch.Generator().manual_seed(0))
        self.model = model.to(self.device).eval()

    def load_state_dict(self, state_dict) -> None:
        self.model.load_state_dict(state_dict, strict=True)

    def load_weights(self, path: str) -> None:
        self.load_state_dict(load_state_dict_file(path))

    @torch.inference_mode()
    def infer(self, wavs, wav_lens):
        """wavs (B, N) float32 / int16 / uint8, lengths (B,) -> (log_probs
        (B, T, V), lens (B,)) on the runner's device."""
        wavs = torch.as_tensor(wavs).to(self.device)
        wav_lens = torch.as_tensor(wav_lens).to(self.device)
        specs, spec_lens = wav_to_spec(self.enc_cfg, wavs, wav_lens)
        return self.model(specs, spec_lens)

    def _decode(self, log_probs, lens):
        return ctc_greedy_decode(log_probs.cpu().numpy(), lens.cpu().numpy(),
                                 self.model.blank_idx)

    def transcribe(self, audio_paths, batch_size: int = 4,
                   overlap_s: float = 3.2):
        """Decode wav files -> texts (greedy). Audio longer than
        ``max_duration`` runs as overlapping windows stitched at the overlap
        midpoints (``_chunked_log_probs``)."""
        texts = [None] * len(audio_paths)
        short = []
        for pos, path in enumerate(audio_paths):
            wav, sr = read_wav(path)
            if sr != self.sample_rate:
                raise ValueError(f"{path}: sample rate {sr} != {self.sample_rate}")
            if len(wav) > self.max_samples:
                lp = self._chunked_log_probs(wav, overlap_s)
                ids = ctc_greedy_decode(lp[None], np.array([lp.shape[0]]),
                                        self.model.blank_idx)[0]
                texts[pos] = self.tokenizer.ids_to_text(ids)
            else:
                short.append((pos, wav))
        for i in range(0, len(short), batch_size):
            group = short[i:i + batch_size]
            padded = np.zeros((len(group), self.max_samples), np.float32)
            lens = np.zeros((len(group),), np.int32)
            for j, (_, w) in enumerate(group):
                padded[j, :len(w)] = w
                lens[j] = len(w)
            ids = self._decode(*self.infer(padded, lens))
            for (pos, _), seq in zip(group, ids):
                texts[pos] = self.tokenizer.ids_to_text(seq)
        return texts

    def _chunked_log_probs(self, wav: np.ndarray, overlap_s: float) -> np.ndarray:
        """Overlapping full-width windows over one long wav, frame log-probs
        stitched at the overlap midpoints (spiral_runner.py:1061-1094)."""
        window = self.max_samples
        ov = min(int(overlap_s * self.sample_rate), window // 2)
        hop = window - ov
        starts = list(range(0, len(wav), hop))
        while len(starts) > 1 and starts[-1] + ov >= len(wav):
            starts.pop()
        pieces = []
        for k, s in enumerate(starts):
            seg = wav[s:s + window]
            padded = np.zeros((1, window), np.float32)
            padded[0, :len(seg)] = seg
            lp, out_len = self.infer(padded, np.array([len(seg)], np.int32))
            lp = lp[0].cpu().numpy()
            f = int(out_len[0])
            frames_per_sample = f / max(len(seg), 1)
            edge = int(round((ov / 2) * frames_per_sample))
            lo = 0 if k == 0 else edge
            hi = f if k == len(starts) - 1 else f - edge
            pieces.append(lp[lo:hi])
        return np.concatenate(pieces, axis=0)

    def evaluate(self, manifest: Optional[str] = None,
                 save_logits_dir: Optional[str] = None, ds_cfg=None) -> dict:
        """Test-mode WER/CER with greedy decoding (spiral_runner.py:1134)."""
        m = self.cfg.model
        ds_cfg = ds_cfg or m.test_ds or m.validation_ds
        manifest = manifest or ds_cfg.manifest_filepath
        dataset = AudioToTextDataset(
            manifest, self.tokenizer, sample_rate=ds_cfg.sample_rate,
            crop_size=self.max_samples,
        )
        loader = DataLoader(
            dataset, ds_cfg.batch_size, AudioTextBatchCollate(self.max_samples, 512),
            shuffle=False, drop_last=False, num_workers=ds_cfg.num_workers,
        )
        hyps, refs = [], []
        for raw in loader:
            log_probs, lens = self.infer(raw["wavs"], raw["wav_lens"])
            for seq, text in zip(self._decode(log_probs, lens), raw["texts"]):
                hyps.append(self.tokenizer.ids_to_text(seq))
                refs.append(text)
            if save_logits_dir:
                os.makedirs(save_logits_dir, exist_ok=True)
                np.save(os.path.join(save_logits_dir, f"logits_{len(hyps)}.npy"),
                        log_probs.cpu().numpy())
        w_err, w_tot = error_counts(hyps, refs)
        c_err, c_tot = error_counts(hyps, refs, use_cer=True)
        err_utts = sum(1 for h, r in zip(hyps, refs) if h.split() != r.split())
        html_path = os.path.join(self.log_dir, "wer_diagnosis.html")
        render_wer_html(hyps, refs, html_path)
        return {
            "wer": w_err / max(w_tot, 1),
            "cer": c_err / max(c_tot, 1),
            "n": len(hyps),
            "ser": err_utts / max(len(hyps), 1),
            "diagnosis_html": html_path,
            "hyps": hyps,
        }
