"""DiffVC any-to-any voice conversion: the port's counterpart of
``cli/inference_vc.py`` (the reference ships this flow as
DiffVC/inference.ipynb).

    python -m tpu_speech_torch.cli.inference_vc -s SRC.wav -t TGT.wav \\
        -c diffvc.pt [--spk-encoder enc.pt] [-n 30] [--mode ml|em|pf|dpm] \\
        [-o OUT.wav] [--device cuda]

Source and target (22 050 Hz wavs) -> HiFi-GAN-convention host mels -> the
target's speaker embedding (the GE2E encoder over 160-frame partials) -> the
source padded to a multiple of 4 frames -> ``voice_convert`` (the
average-voice encoder on both mels, then ``-n`` steps of the conditional
U-Net; ``--mode dpm`` is DPM-Solver++(2M) on the probability-flow ODE) ->
spectral-subtraction denoising on the host -> 32 iterations of momentum
Griffin-Lim -> ``-o``, 16-bit PCM at 22 050 Hz: hop x (frames - 1) samples,
as the JAX CLI writes. ``main`` returns the output's path, frames, samples
and seconds, the host time of each stage (a stage on the card ends with a
read or a sync), and whether the mel and the wav are finite: on an untrained
checkpoint the sampler drifts far from the average voice (the score does not
cancel the drift), and the denoiser's exp overflows, as the JAX CLI's does.
The JAX CLI's docstring names HiFi-GAN, but its code vocodes with
Griffin-Lim only (``cli/inference_vc.py:5-6, 146-148``); this CLI follows
the code (ROADMAP.md, Queue 3).

Checkpoints: ``-c`` takes a reference DiffVC state_dict (``.pt``; its names
are the port's) or the JAX package's params in an ``.npz`` (``params/<path>``
keys, through ``compat/jax_diffvc.py::diffvc_from_jax``); an orbax
directory raises (ROADMAP.md, Queue 1). ``--spk-encoder`` takes a reference
``{'model_state': ...}`` file; without it the encoder keeps a seeded random
init, with a warning, as the JAX CLI keeps flax's. ``--device`` defaults to
``cuda`` and raises without a card; ``cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from tpu_speech_torch.audio.mel import mel_spectrogram_np
from tpu_speech_torch.audio.vocode import fast_griffin_lim
from tpu_speech_torch.compat.jax_diffvc import diffvc_from_jax
from tpu_speech_torch.compat.jax_spiral import load_jax_npz
from tpu_speech_torch.configs import diffvc as params
from tpu_speech_torch.data.wav import read_wav, write_wav
from tpu_speech_torch.models.diffvc import DiffVC, voice_convert
from tpu_speech_torch.models.speaker_encoder import (
    SpeakerEncoder,
    embed_utterance,
    preprocess_wav,
)
from tpu_speech_torch.ops.masks import fix_len_compatibility
from tpu_speech_torch.utils.device import resolve_device


def get_mel(wav_path):
    wav, sr = read_wav(wav_path)
    assert sr == params.sampling_rate, f"{wav_path}: {sr}"
    wav = wav[: (len(wav) // params.hop_size) * params.hop_size]
    return mel_spectrogram_np(wav[None])[0]  # (T, 80)


def noise_median_smoothing(x, w=5):
    y = np.copy(x)
    x = np.pad(x, w, "edge")
    for i in range(y.shape[0]):
        med = np.median(x[i : i + 2 * w + 1])
        y[i] = min(x[i + w + 1], med)
    return y


def mel_spectral_subtraction(mel_synth, mel_source, spectral_floor=0.02,
                             silence_window=5, smoothing_window=1):
    """Notebook's denoiser; mels here are (T, F)."""
    ms, msrc = mel_synth.T, mel_source.T  # (F, T)
    mel_len = msrc.shape[-1]
    energy_min, i_min = 1e9, 0
    for i in range(mel_len - silence_window):
        e = np.sum(np.exp(2.0 * msrc[:, i : i + silence_window]))
        if e < energy_min:
            i_min, energy_min = i, e
    noise = np.min(np.exp(2.0 * ms[:, i_min : i_min + silence_window]), axis=-1)
    if smoothing_window is not None:
        noise = noise_median_smoothing(noise, smoothing_window)
    out = np.copy(ms)
    for i in range(mel_len):
        sig = np.exp(2.0 * ms[:, i]) - noise
        est = np.maximum(sig, spectral_floor * noise)
        out[:, i] = np.log(np.sqrt(est))
    return out.T


def load_diffvc_state_dict(path: str):
    """A DiffVC checkpoint -> the port's (the reference's) state_dict."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path}: orbax checkpoints are not ported yet (ROADMAP.md, Queue 1); pass a "
            ".pt state_dict or an .npz of JAX params")
    if path.endswith(".npz"):
        return diffvc_from_jax(load_jax_npz(path, ("params",))[0], params.layers,
                               params.use_ref_t)
    return torch.load(path, map_location="cpu", weights_only=True)


def load_speaker_encoder(path, device) -> SpeakerEncoder:
    """The GE2E speaker encoder from a reference ``{'model_state': ...}``
    file (or a bare state_dict), or, without one, a seeded random init."""
    model = SpeakerEncoder()
    if path:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        model.load_state_dict(sd.get("model_state", sd))
    else:
        print("WARNING: no speaker-encoder checkpoint; using random init")
        model.init_weights(torch.Generator().manual_seed(0))
    return model.to(device).eval()


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("-s", "--source", required=True, help="source wav (content)")
    parser.add_argument("-t", "--target", required=True, help="target wav (voice)")
    parser.add_argument("-c", "--checkpoint", required=True,
                        help="DiffVC checkpoint (.pt state_dict or .npz of JAX params)")
    parser.add_argument("--spk-encoder", default=None,
                        help="speaker-encoder checkpoint (.pt, {'model_state': ...})")
    parser.add_argument("-n", "--timesteps", type=int, default=30)
    parser.add_argument("--mode", default="ml", choices=["pf", "em", "ml", "dpm"],
                        help="dpm = DPM-Solver++(2M) on the pf ODE "
                             "(1 net call/step; -n 6 beats pf at 30 steps)")
    parser.add_argument("-o", "--output", default="./out/converted.wav")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs on the CPU")
    return parser


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    model = DiffVC(**params.model_kwargs())
    model.load_state_dict(load_diffvc_state_dict(args.checkpoint))
    model.to(device).eval()
    spk_model = load_speaker_encoder(args.spk_encoder, device)
    times = {}

    t0 = time.perf_counter()
    mel_src = get_mel(args.source)
    mel_tgt = get_mel(args.target)
    times["mels"] = time.perf_counter() - t0

    # speaker embedding of the target voice
    t0 = time.perf_counter()
    wav_tgt, sr = read_wav(args.target)
    wav_pre = preprocess_wav(wav_tgt, source_sr=sr)
    with torch.inference_mode():
        c = embed_utterance(spk_model, wav_pre)[None]  # (1, 256)
    sync()
    times["embedding"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    n_frames, t_tgt = mel_src.shape[0], mel_tgt.shape[0]
    x = np.zeros((1, fix_len_compatibility(n_frames), params.n_mels), np.float32)
    x[0, :n_frames] = mel_src
    generator = torch.Generator(device).manual_seed(0)
    with torch.inference_mode():
        _, y = voice_convert(
            model, torch.from_numpy(x).to(device),
            torch.tensor([n_frames], device=device),
            torch.from_numpy(mel_tgt[None]).to(device), torch.tensor([t_tgt], device=device),
            c, args.timesteps, args.mode, generator=generator)
        mel_out = y[0, :n_frames].cpu().numpy()
    times["conversion"] = time.perf_counter() - t0
    finite = {"mel": bool(np.isfinite(mel_out).all())}
    max_abs_mel = float(np.abs(mel_out).max())

    t0 = time.perf_counter()
    mel_out = mel_spectral_subtraction(mel_out, mel_src, smoothing_window=1)
    times["denoise"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    with torch.inference_mode():
        wav_out = fast_griffin_lim(torch.from_numpy(mel_out[None]).to(device),
                                   n_iters=32)[0].cpu().numpy()
    times["griffin_lim"] = time.perf_counter() - t0
    finite["wav"] = bool(np.isfinite(wav_out).all())
    if not all(finite.values()):
        print(f"WARNING: not finite: {finite}; max |mel| {max_abs_mel} (an untrained score "
              "lets the sampler drift ~150x the noise away from the average voice)")

    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    write_wav(args.output, wav_out, params.sampling_rate)
    seconds = len(wav_out) / params.sampling_rate
    print(f"Wrote {args.output} ({seconds:.2f}s)")
    return {"output": args.output, "frames": n_frames, "samples": len(wav_out),
            "seconds": seconds, "times": times, "finite": finite, "max_abs_mel": max_abs_mel}


if __name__ == "__main__":
    main()
