"""Grad-TTS + HiFi-GAN text-to-waveform serving: the port's counterpart of
``cli/inference.py`` (the reference Grad-TTS/inference.py surface).

    python -m tpu_speech_torch.cli.inference -f texts.txt -c grad-tts.pt \\
        --hifigan hifigan.pt --hifigan-config hifigan-config.json [--device cpu]

Each line of the texts file goes text -> ids -> ``GradTTS`` encoder ->
durations -> ``-t`` sampler steps (Euler, or ``--solver dpm``) -> HiFi-GAN
-> ``out-dir/sample_{i}.wav`` as int16 PCM, quantized on the device. Without
a vocoder checkpoint and config it writes ``sample_{i}_mel.npy``. Each line
prints its RTF, t * sample_rate / (frames * hop), with t from the encoder to
the decoder's output after a device sync. A mel or waveform that is not
finite raises.

Checkpoints: ``-c`` takes a reference PyTorch state_dict (``.pt``; its
names are the port's) or JAX trees in an ``.npz`` (``params/<path>`` keys,
through ``compat/jax_gradtts.py::gradtts_from_jax``); ``--hifigan`` a
reference generator state_dict (``weight_g``/``weight_v`` pairs are folded,
a ``{"generator": ...}`` wrapper is unwrapped). ``-c`` also takes the
``.tpu_speech`` archive that the JAX package's ``GradTTSTrainer.save_archive``
writes (``utils/archive.py``). Orbax directories raise (ROADMAP.md, Queue 1).
``--cmudict`` names the CMU dictionary (default the config's
``resources/cmu_dictionary``; an empty string gives character input).

Lengths: the JAX CLI passes ``y_max_length`` 256 (``cli/params.py:55``), and
``synthesize`` clips every line to it, so a line longer than 256 frames is
cut there (ROADMAP.md, Queue 3). Here the encoder runs first, and the
sampler gets the smallest multiple of 256 frames that covers the predicted
length: nothing is cut. ``--device`` defaults to ``cuda`` and raises
without a card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np
import torch

from tpu_speech_torch.compat.jax_gradtts import fold_weight_norm, gradtts_from_jax
from tpu_speech_torch.compat.jax_spiral import load_jax_npz
from tpu_speech_torch.configs import gradtts as cfg
from tpu_speech_torch.data.wav import write_wav
from tpu_speech_torch.models.grad_tts import GradTTS, durations, synthesize_from_encoding
from tpu_speech_torch.models.hifigan import Generator, to_int16_pcm
from tpu_speech_torch.text import CMUDict, intersperse, symbols, text_to_sequence
from tpu_speech_torch.utils.archive import load_archive
from tpu_speech_torch.utils.device import resolve_device

HIFIGAN_CONFIG = "./checkpts/hifigan-config.json"
HIFIGAN_CHECKPT = "./checkpts/hifigan.pt"


def _refuse_unported(path: str) -> None:
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path}: orbax checkpoints are not ported (ROADMAP.md, Queue 1); pass a .pt "
            "state_dict, an .npz of JAX trees or a .tpu_speech archive")


def load_gradtts_state_dict(path: str, n_enc_layers: int, n_spks: int):
    """A Grad-TTS checkpoint -> the port's (the reference's) state_dict."""
    _refuse_unported(path)
    if path.endswith(".npz"):
        return gradtts_from_jax(load_jax_npz(path, ("params",))[0], n_enc_layers, n_spks)
    if path.endswith(".tpu_speech"):  # GradTTSTrainer.save_archive's (gradtts.py:153-164)
        return gradtts_from_jax(load_archive(path)[1], n_enc_layers, n_spks)
    return torch.load(path, map_location="cpu", weights_only=True)


def load_hifigan(config_path: str, ckpt_path: str):
    """The HiFi-GAN generator of a reference config and checkpoint, or None
    when either file is missing (the CLI then writes mels)."""
    if not (os.path.exists(config_path) and os.path.exists(ckpt_path)):
        return None
    with open(config_path) as f:
        h = json.load(f)
    gen = Generator(
        resblock=h["resblock"],
        upsample_rates=tuple(h["upsample_rates"]),
        upsample_kernel_sizes=tuple(h["upsample_kernel_sizes"]),
        upsample_initial_channel=h["upsample_initial_channel"],
        resblock_kernel_sizes=tuple(h["resblock_kernel_sizes"]),
        resblock_dilation_sizes=tuple(tuple(d) for d in h["resblock_dilation_sizes"]),
        n_mels=h.get("num_mels", cfg.n_feats),
    )
    sd = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    if "generator" in sd:
        sd = sd["generator"]
    gen.load_state_dict(fold_weight_norm(sd))
    return gen


def covering_bucket(frames: float, bucket: int = cfg.y_max_length_bucket) -> int:
    """The smallest positive multiple of ``bucket`` that holds ``frames``."""
    return bucket * max(1, math.ceil(frames / bucket))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("-f", "--file", type=str, required=True,
                        help="path to a file with texts to synthesize")
    parser.add_argument("-c", "--checkpoint", type=str, required=True,
                        help="path to a checkpoint of Grad-TTS")
    parser.add_argument("-t", "--timesteps", type=int, default=10,
                        help="number of timesteps of reverse diffusion")
    parser.add_argument("-s", "--speaker_id", type=int, default=None,
                        help="speaker id for multispeaker model")
    parser.add_argument("--solver", type=str, default="euler", choices=["euler", "dpm"],
                        help="dpm = DPM-Solver++(2M) on the probability-flow ODE (one "
                             "network call per step)")
    parser.add_argument("--length-scale", type=float, default=0.91,
                        help="duration scale (the reference's inference.py uses 0.91)")
    parser.add_argument("--temperature", type=float, default=1.5,
                        help="z = mu_y + N(0, I) / temperature (the reference's 1.5)")
    parser.add_argument("--hifigan", type=str, default=HIFIGAN_CHECKPT)
    parser.add_argument("--hifigan-config", type=str, default=HIFIGAN_CONFIG)
    parser.add_argument("--out-dir", type=str, default="./out")
    parser.add_argument("--cmudict", type=str, default=cfg.cmudict_path,
                        help="CMU dictionary file; '' for character input")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs on the CPU")
    return parser


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    spk = None
    if args.speaker_id is not None:
        if cfg.n_spks <= 1:
            raise SystemExit("set n_spks in configs/gradtts.py for a multispeaker model")
        spk = torch.tensor([args.speaker_id], device=device)

    print("Initializing Grad-TTS...")
    model = GradTTS(**cfg.model_kwargs(len(symbols) + 1))
    model.load_state_dict(load_gradtts_state_dict(args.checkpoint, cfg.n_enc_layers,
                                                  cfg.n_spks))
    model.to(device).eval()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"Number of parameters: {n_params}")

    print("Initializing HiFi-GAN...")
    vocoder = load_hifigan(args.hifigan_config, args.hifigan)
    n_vocoder_params = 0
    if vocoder is None:
        print("  (no vocoder checkpoint found; writing mels only)")
    else:
        vocoder.to(device).eval()
        n_vocoder_params = sum(p.numel() for p in vocoder.parameters())
        print(f"Number of vocoder parameters: {n_vocoder_params}")

    with open(args.file, encoding="utf-8") as f:
        texts = [line.strip() for line in f if line.strip()]
    cmu = CMUDict(args.cmudict) if args.cmudict else None
    os.makedirs(args.out_dir, exist_ok=True)

    samples = []
    for i, text in enumerate(texts):
        print(f"Synthesizing {i} text...", end=" ", flush=True)
        seq = intersperse(text_to_sequence(text, dictionary=cmu), len(symbols))
        x = torch.tensor([seq], dtype=torch.long, device=device)
        x_lengths = torch.tensor([len(seq)], dtype=torch.long, device=device)
        generator = torch.Generator(device).manual_seed(i)
        t0 = time.perf_counter()
        with torch.inference_mode():
            mu_x, logw, x_mask = model.encode(x, x_lengths, spk)
            # the one host read before the sampler: the predicted length
            frames = float(durations(logw, x_mask, args.length_scale).sum())
            y_max_length = covering_bucket(frames)
            _, y_dec, _, y_lengths = synthesize_from_encoding(
                model, mu_x, logw, x_mask, args.timesteps, y_max_length,
                temperature=args.temperature, stoc=False, spk=spk,
                length_scale=args.length_scale, generator=generator, solver=args.solver)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        t = time.perf_counter() - t0
        n_frames = int(y_lengths[0])
        rtf = t * cfg.sample_rate / (n_frames * cfg.hop_length)
        print(f"Grad-TTS RTF: {rtf}")

        mel = y_dec[:, :n_frames, :]
        if not bool(torch.isfinite(mel).all()):
            raise FloatingPointError(f"line {i}: the decoder's mel is not finite")
        if vocoder is not None:
            with torch.inference_mode():
                wav = vocoder(mel.transpose(1, 2))
                if not bool(torch.isfinite(wav).all()):
                    raise FloatingPointError(f"line {i}: the vocoder's wav is not finite")
                pcm = to_int16_pcm(wav)[0, 0].cpu().numpy()
            path = os.path.join(args.out_dir, f"sample_{i}.wav")
            write_wav(path, pcm, cfg.sample_rate)
        else:
            path = os.path.join(args.out_dir, f"sample_{i}_mel.npy")
            np.save(path, mel[0].cpu().numpy())
        samples.append({"text": text, "path": path, "frames": n_frames,
                        "predicted_frames": frames, "y_max_length": y_max_length,
                        "seconds": t, "rtf": rtf})

    print(f"Done. Check out `{args.out_dir}` folder for samples.")
    return {"n_params": n_params, "n_vocoder_params": n_vocoder_params,
            "samples": samples}


if __name__ == "__main__":
    main()
