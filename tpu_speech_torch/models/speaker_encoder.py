"""The GE2E speaker encoder (Real-Time-Voice-Cloning style) and its host
frontend.

The port's counterpart of ``tpu_speech/models/speaker_encoder.py`` (the
reference DiffVC/speaker_encoder/encoder/{model,audio,inference}.py): a
3-layer LSTM over 40-mel power frames at 16 kHz, the last layer's final
hidden state -> Linear -> ReLU -> L2 normalisation (floor 1e-12), a 256-d
embedding; at inference the utterance is cut into
overlapping 160-frame partials whose embeddings are averaged and
normalised. The module tree is the reference's (``lstm.weight_ih_l0``,
``linear``, ``similarity_weight``/``similarity_bias``), so a reference
``{'model_state': ...}`` checkpoint loads as it is; the two GE2E scalars
score training only, in ``similarity_matrix`` and ``ge2e_loss`` (on the
device) and ``equal_error_rate`` (host numpy).

The frontend (``wav_to_mel_spectrogram``, ``normalize_volume``,
``trim_long_silences``, ``preprocess_wav``, ``compute_partial_slices``) is
host numpy, the JAX package's copied.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tpu_speech_torch.audio.mel import hann_window, mel_filterbank

# data hyperparameters (encoder/params_data.py)
SAMPLING_RATE = 16000
MEL_WINDOW_LENGTH_MS = 25
MEL_WINDOW_STEP_MS = 10
MEL_N_CHANNELS = 40
PARTIALS_N_FRAMES = 160
AUDIO_NORM_TARGET_DBFS = -30

# model hyperparameters (encoder/params_model.py)
MODEL_HIDDEN_SIZE = 256
MODEL_EMBEDDING_SIZE = 256
MODEL_NUM_LAYERS = 3


class SpeakerEncoder(nn.Module):
    """Utterance mel frames (B, T, 40) -> L2-normalised embeddings (B, 256)
    (model.py:14-62)."""

    def __init__(self, hidden_size: int = MODEL_HIDDEN_SIZE,
                 embedding_size: int = MODEL_EMBEDDING_SIZE,
                 num_layers: int = MODEL_NUM_LAYERS):
        super().__init__()
        self.lstm = nn.LSTM(MEL_N_CHANNELS, hidden_size, num_layers, batch_first=True)
        self.linear = nn.Linear(hidden_size, embedding_size)
        self.relu = nn.ReLU()
        self.similarity_weight = nn.Parameter(torch.tensor([10.0]))
        self.similarity_bias = nn.Parameter(torch.tensor([-5.0]))

    def forward(self, utterances: torch.Tensor) -> torch.Tensor:
        _, (hidden, _) = self.lstm(utterances)
        embeds_raw = self.relu(self.linear(hidden[-1]))
        norm = torch.linalg.vector_norm(embeds_raw, dim=1, keepdim=True)
        return embeds_raw / torch.clamp(norm, min=1e-12)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "SpeakerEncoder":
        """Seeded random weights with the JAX package's initial
        distributions (not its draws): LSTM weights uniform in
        +-1/sqrt(hidden), LSTM biases zero, the linear weight normal with
        std 1/sqrt(fan_in) and its bias zero."""
        bound = self.lstm.hidden_size ** -0.5
        for name, p in self.lstm.named_parameters():
            if name.startswith("weight"):
                p.copy_(torch.rand(p.shape, generator=generator) * 2 * bound - bound)
            else:
                p.zero_()
        w = self.linear.weight
        w.copy_(torch.randn(w.shape, generator=generator) * w.shape[1] ** -0.5)
        self.linear.bias.zero_()
        return self


def similarity_matrix(embeds: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """GE2E similarity (model.py:64-110): embeds (S, U, E) -> (S, U, S),
    each utterance against every speaker's centroid, its own speaker's
    centroid without it; scaled by ``weight`` and shifted by ``bias``."""
    s, u, _ = embeds.shape
    centroids_incl = embeds.mean(1, keepdim=True)  # (S, 1, E)
    centroids_incl = centroids_incl / torch.linalg.vector_norm(centroids_incl, dim=2,
                                                               keepdim=True)
    centroids_excl = (embeds.sum(1, keepdim=True) - embeds) / (u - 1)
    centroids_excl = centroids_excl / torch.linalg.vector_norm(centroids_excl, dim=2,
                                                               keepdim=True)
    sim_incl = torch.einsum("sue,te->sut", embeds, centroids_incl[:, 0, :])
    sim_excl = torch.sum(embeds * centroids_excl, dim=2)  # (S, U)
    eye = torch.eye(s, dtype=embeds.dtype, device=embeds.device)[:, None, :]
    sim = sim_incl * (1 - eye) + sim_excl[:, :, None] * eye
    return sim * weight + bias


def ge2e_loss(embeds: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor):
    """GE2E softmax loss (model.py:112-140): (mean cross-entropy of each
    utterance's row against its speaker, the (S U, S) similarity)."""
    s, u, _ = embeds.shape
    sim = similarity_matrix(embeds, weight, bias).reshape(s * u, s)
    target = torch.arange(s * u, device=embeds.device) // u  # each row's speaker
    logp = torch.log_softmax(sim, dim=-1)
    loss = -torch.mean(torch.gather(logp, 1, target[:, None]))
    return loss, sim


def equal_error_rate(sim: np.ndarray, n_speakers: int) -> float:
    """EER from the flattened similarity matrix (host numpy)."""
    sim = np.asarray(sim).reshape(-1, n_speakers)
    n = sim.shape[0]
    u = n // n_speakers
    labels = np.zeros_like(sim, dtype=bool)
    for i in range(n):
        labels[i, i // u] = True
    scores = sim.flatten()
    truth = labels.flatten()
    order = np.argsort(-scores)
    truth = truth[order]
    tpr = np.cumsum(truth) / max(truth.sum(), 1)
    fpr = np.cumsum(~truth) / max((~truth).sum(), 1)
    # EER: point where FPR crosses 1 - TPR
    diffs = fpr - (1 - tpr)
    idx = int(np.argmin(np.abs(diffs)))
    return float((fpr[idx] + (1 - tpr[idx])) / 2)


# ---------------------------------------------------------------------------
# audio frontend (encoder/audio.py), host numpy
# ---------------------------------------------------------------------------


def wav_to_mel_spectrogram(wav: np.ndarray) -> np.ndarray:
    """Power (not log) mel frames at 16 kHz, (T, 40). librosa-compatible
    melspectrogram: center=True, hann, power=2."""
    n_fft = int(SAMPLING_RATE * MEL_WINDOW_LENGTH_MS / 1000)
    hop = int(SAMPLING_RATE * MEL_WINDOW_STEP_MS / 1000)
    window = hann_window(n_fft)
    basis = mel_filterbank(SAMPLING_RATE, n_fft, MEL_N_CHANNELS, 0.0, SAMPLING_RATE / 2)
    pad = n_fft // 2
    y = np.pad(np.asarray(wav, dtype=np.float32), (pad, pad), mode="reflect")
    num_frames = 1 + (len(y) - n_fft) // hop
    idx = np.arange(num_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    frames = y[idx] * window
    spec = np.fft.rfft(frames, axis=-1)
    power = (spec.real**2 + spec.imag**2).astype(np.float32)
    return power @ basis.T  # (T, 40)


def normalize_volume(wav, target_dbfs=AUDIO_NORM_TARGET_DBFS, increase_only=True,
                     decrease_only=False):
    dbfs_change = target_dbfs - 10 * np.log10(np.mean(wav**2) + 1e-12)
    if (dbfs_change < 0 and increase_only) or (dbfs_change > 0 and decrease_only):
        return wav
    return wav * (10 ** (dbfs_change / 20))


def trim_long_silences(wav: np.ndarray, frame_ms: int = 30,
                       max_silence_frames: int = 6) -> np.ndarray:
    """Energy-based VAD approximation of the reference's webrtcvad pipeline
    (encoder/audio.py:120-160; webrtcvad is not available here)."""
    frame = int(SAMPLING_RATE * frame_ms / 1000)
    n = len(wav) // frame * frame
    if n == 0:
        return wav
    frames = wav[:n].reshape(-1, frame)
    rms = np.sqrt(np.mean(frames**2, axis=1))
    thresh = max(np.median(rms) * 0.1, 1e-4)
    voiced = rms > thresh
    # dilate: keep silence gaps up to max_silence_frames
    keep = voiced.copy()
    run = 0
    for i in range(len(voiced)):
        if voiced[i]:
            run = 0
        else:
            run += 1
            if run <= max_silence_frames:
                keep[i] = True
    mask = np.repeat(keep, frame)
    return wav[: len(mask)][mask]


def preprocess_wav(wav: np.ndarray, source_sr: Optional[int] = None) -> np.ndarray:
    """Resample -> volume-normalize -> trim silences (encoder/audio.py:20-47)."""
    if source_sr is not None and source_sr != SAMPLING_RATE:
        import scipy.signal

        n_out = int(round(len(wav) * SAMPLING_RATE / source_sr))
        wav = scipy.signal.resample_poly(
            wav, SAMPLING_RATE // np.gcd(SAMPLING_RATE, source_sr),
            source_sr // np.gcd(SAMPLING_RATE, source_sr),
        ).astype(np.float32)[:n_out + 1]
    wav = normalize_volume(wav, increase_only=True)
    return trim_long_silences(wav)


def compute_partial_slices(
    n_samples: int,
    partial_utterance_n_frames: int = PARTIALS_N_FRAMES,
    min_pad_coverage: float = 0.75,
    overlap: float = 0.5,
) -> Tuple[List[slice], List[slice]]:
    """Split points for overlapping partial utterances (inference.py:58-105)."""
    samples_per_frame = int(SAMPLING_RATE * MEL_WINDOW_STEP_MS / 1000)
    n_frames = int(np.ceil((n_samples + 1) / samples_per_frame))
    frame_step = max(int(np.round(partial_utterance_n_frames * (1 - overlap))), 1)

    wav_slices, mel_slices = [], []
    steps = max(1, n_frames - partial_utterance_n_frames + frame_step + 1)
    for i in range(0, steps, frame_step):
        mel_range = np.array([i, i + partial_utterance_n_frames])
        wav_range = mel_range * samples_per_frame
        mel_slices.append(slice(*mel_range))
        wav_slices.append(slice(*wav_range))

    last = wav_slices[-1]
    coverage = (n_samples - last.start) / (last.stop - last.start)
    if coverage < min_pad_coverage and len(mel_slices) > 1:
        mel_slices = mel_slices[:-1]
        wav_slices = wav_slices[:-1]
    return wav_slices, mel_slices


def embed_utterance(model: SpeakerEncoder, wav: np.ndarray) -> torch.Tensor:
    """One utterance's embedding (256,) on the model's device, with
    partial-slice averaging (inference.py:108-144; the JAX package's
    ``using_partials=False`` has no caller). The partials' mel frames are
    made on the host; their embeddings' mean and its normalisation stay on
    the device."""
    wave_slices, mel_slices = compute_partial_slices(len(wav))
    max_wave_length = wave_slices[-1].stop
    if max_wave_length >= len(wav):
        wav = np.pad(wav, (0, max_wave_length - len(wav)), "constant")
    frames = wav_to_mel_spectrogram(wav)
    batch = torch.from_numpy(np.stack([frames[s] for s in mel_slices]))
    raw = model(batch.to(next(model.parameters()).device)).mean(0)
    return raw / torch.linalg.vector_norm(raw)
