"""Export the Grad-TTS serving graph (text ids -> waveform) with torch.export:
the port's counterpart of ``cli/export_tts.py``.

    python -m tpu_speech_torch.cli.export_tts -c grad-tts.pt -o tts.pt2 \\
        [--hifigan hifigan.pt --hifigan-config hifigan-config.json | --mel-only] \\
        [-t 10] [--max-text-len 128] [--max-frames 0] [--batch-size 1] [--bf16] \\
        [--verify] [--device cuda]

The whole pipeline (encoder, durations and alignment, the ``-t`` Euler steps
of the reverse SDE, the HiFi-GAN vocoder) is traced as one program with the
weights saved in it, so a program serves it without the Python model
definitions (``utils/export.py::load_exported``). The shapes are static: the
batch, the text length and the mel bucket (``--max-frames``, default the
config's ``y_max_length_bucket``).

Inputs of the exported program: (x [B, max_text_len] int32 token ids,
x_lengths [B] int32, seed [] int32[, spk [B] int32]). Outputs: (wav [B,
max_frames * hop] float32, wav_lengths [B] int32), or (mel [B, max_frames,
n_feats] float32, y_lengths [B] int32) with ``--mel-only`` or without a
vocoder checkpoint; the mel frames past y_lengths are zeroed before the
vocoder, so the waveform's tail is silence. ``seed`` is a graph input: the
diffusion noise is a function of it alone (``ops/random.py::counter_normal``),
not JAX's stream. ``--bf16`` serves on bf16 copies of both models'
parameters (``utils/precision.py``); the outputs stay float32.

An ``ExportedProgram`` is traced for one device, so ``--device`` (default
``cuda``, which raises without a card) takes the place of JAX's
``--platforms`` (ROADMAP Queue 3). ``-c`` takes what ``cli/inference.py -c``
takes.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from tpu_speech_torch.cli.inference import load_gradtts_state_dict, load_hifigan
from tpu_speech_torch.configs import gradtts as cfg
from tpu_speech_torch.models.grad_tts import GradTTS, synthesize_from_encoding
from tpu_speech_torch.ops.random import counter_normal
from tpu_speech_torch.text import symbols
from tpu_speech_torch.utils.device import resolve_device
from tpu_speech_torch.utils.export import export_fn, load_exported
from tpu_speech_torch.utils.precision import cast_params_bf16


class ServingGraph(torch.nn.Module):
    """The serving function as a module, the models as its submodules (so
    that ``torch.export`` saves their weights)."""

    def __init__(self, model: GradTTS, vocoder, n_timesteps: int, y_max_length: int,
                 hop_length: int, temperature: float, length_scale: float):
        super().__init__()
        self.model, self.vocoder = model, vocoder
        self.n_timesteps, self.y_max_length = n_timesteps, y_max_length
        self.hop_length = hop_length
        self.temperature, self.length_scale = temperature, length_scale

    def forward(self, x, x_lengths, seed, spk=None):
        model = self.model
        mu_x, logw, x_mask = model.encode(x, x_lengths, spk)
        noise = counter_normal(seed, (x.shape[0], self.y_max_length, model.n_feats),
                               device=x.device).to(mu_x.dtype)
        _, mel, _, y_lengths = synthesize_from_encoding(
            model, mu_x, logw, x_mask, self.n_timesteps, self.y_max_length,
            temperature=self.temperature, spk=spk, length_scale=self.length_scale,
            noise=noise)
        mel = mel.float()
        if self.vocoder is None:
            return mel, y_lengths
        frame_valid = torch.arange(mel.shape[1], device=mel.device)[None, :] < y_lengths[:, None]
        mel = torch.where(frame_valid[:, :, None], mel, 0.0)
        dtype = self.vocoder.conv_pre.weight.dtype  # bf16 under --bf16
        wav = self.vocoder(mel.to(dtype).transpose(1, 2)).float()[:, 0]
        return wav, y_lengths * self.hop_length


def build_serving_fn(
    model: GradTTS,
    vocoder=None,
    n_timesteps: int = 10,
    y_max_length: int = 384,
    max_text_len: int = 128,
    hop_length: int = 256,
    temperature: float = 1.5,
    length_scale: float = 0.91,
    batch_size: int = 1,
    multispeaker: bool = False,
    bf16: bool = False,
    device=None,
):
    """(fn, example_args) of the one-program text -> waveform serving graph
    (``cli/export_tts.py::build_serving_fn:39``): ``fn`` a ``ServingGraph``
    in eval mode on ``device`` (default the model's), on bf16 copies of
    the models' parameters under ``bf16``; ``seed`` is an input, so the
    caller controls the diffusion noise."""
    device = torch.device(device) if device is not None else next(model.parameters()).device
    if bf16:
        model = cast_params_bf16(model)
        vocoder = None if vocoder is None else cast_params_bf16(vocoder)
    fn = ServingGraph(model, vocoder, n_timesteps, y_max_length, hop_length, temperature,
                      length_scale).to(device).eval()
    x = torch.zeros((batch_size, max_text_len), dtype=torch.int32, device=device)
    xl = torch.full((batch_size,), max_text_len, dtype=torch.int32, device=device)
    seed = torch.zeros((), dtype=torch.int32, device=device)
    if multispeaker:
        return fn, (x, xl, seed, torch.zeros((batch_size,), dtype=torch.int32, device=device))
    return fn, (x, xl, seed)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-c", "--checkpoint", type=str, required=True,
                   help="Grad-TTS checkpoint (.pt, .npz of JAX trees or .tpu_speech)")
    p.add_argument("-o", "--output", type=str, required=True, help="output .pt2 path")
    p.add_argument("-t", "--timesteps", type=int, default=10)
    p.add_argument("--hifigan", type=str, default="./checkpts/hifigan.pt")
    p.add_argument("--hifigan-config", type=str, default="./checkpts/hifigan-config.json")
    p.add_argument("--mel-only", action="store_true", help="export without the vocoder stage")
    p.add_argument("--max-text-len", type=int, default=128)
    p.add_argument("--max-frames", type=int, default=0,
                   help="mel bucket (0 = the config's y_max_length_bucket)")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--bf16", action="store_true",
                   help="bake bf16 weights/compute (fp32 outputs)")
    p.add_argument("--device", type=str, default="cuda",
                   help="the device the program is traced for (JAX's --platforms)")
    p.add_argument("--verify", action="store_true",
                   help="reload the artifact and run it on zeros")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    model = GradTTS(**cfg.model_kwargs(len(symbols) + 1))
    model.load_state_dict(load_gradtts_state_dict(args.checkpoint, cfg.n_enc_layers,
                                                  cfg.n_spks))
    vocoder = None
    if not args.mel_only:
        vocoder = load_hifigan(args.hifigan_config, args.hifigan)
        if vocoder is None:
            print("no vocoder checkpoint found; exporting mel-only")

    fn, ex = build_serving_fn(
        model, vocoder, n_timesteps=args.timesteps,
        y_max_length=args.max_frames or cfg.y_max_length_bucket,
        max_text_len=args.max_text_len, hop_length=cfg.hop_length,
        batch_size=args.batch_size, multispeaker=cfg.n_spks > 1, bf16=args.bf16,
        device=device)
    export_fn(fn, ex, args.output)
    size_mb = os.path.getsize(args.output) / 1e6
    print(f"exported: {args.output} ({size_mb:.1f} MB, device={device})")
    out = {"path": args.output, "bytes": os.path.getsize(args.output),
           "vocoder": vocoder is not None}
    if args.verify:
        outs = load_exported(args.output).call(*ex)
        first = outs[0].cpu().numpy()
        out.update(shape=tuple(first.shape), finite=bool(np.isfinite(first).all()))
        print(f"verify ok: output shape {out['shape']}, finite={out['finite']}")
    return out


if __name__ == "__main__":
    main()
