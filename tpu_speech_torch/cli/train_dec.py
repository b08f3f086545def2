"""DiffVC stage 2, the speaker-conditional diffusion decoder with the frozen
stage-1 encoder: the port's counterpart of ``cli/train_dec.py`` (the
reference DiffVC/train_dec.py recipe: Adam 1e-4, batch 32, 110 epochs).

    python -m tpu_speech_torch.cli.train_dec --data-dir D --enc-ckpt enc.pt \\
        [--val-file F] [--exc-file F] [--log-dir logs/dec] [--epochs 110] \\
        [--batch-size 32] [--lr 1e-4] [--device cuda]

``D/mels`` and ``D/embeds`` (speakers with 10 utterances or more) -> two
independent crops of each utterance -> ``train/diffvc.py::dec_train_step``
on the device -> ``train.log``, TensorBoard, a checkpoint each epoch in
``<log-dir>/ckpt``, the previews (a conversion of two items to their own
voice: Griffin-Lim wavs, and mel images where matplotlib is installed). A
run on a log dir that holds checkpoints resumes from the latest one, at the
epoch after it. At the end it writes ``<log-dir>/diffvc.pt``, the whole
model's reference-named state_dict, which ``cli.inference_vc -c`` loads.

``--enc-ckpt`` (``load_encoder_params``) takes the encoder's state_dict as
``cli.train_enc`` writes it or as the reference saves it (a ``FwdDiffusion``
``.pt``), or an ``.npz`` of the JAX package's encoder tree
(``params/<path>`` keys); an orbax directory raises (ROADMAP.md, Queue 1).
The decoder's initial weights are the reference's after
``torch.manual_seed(seed)``. ``--device`` defaults to ``cuda`` and raises
without a card. ``--precision bf16`` trains on bf16 copies of the float32
parameters (``train/diffvc.py``, the JAX step's ``bf16``).

Several cards (``parallel/launch.py``): one rank per visible card,
``--batch-size`` the global batch (it must divide by the ranks), the step
the one-process step on the global batch; torchrun's variables and N gloo
ranks on the CPU work too. Rank 0 alone writes the log dir's files.
"""

from __future__ import annotations

import argparse
import sys
import os
from typing import Dict

import torch

from tpu_speech_torch.cli.train_enc import images_available
from tpu_speech_torch.compat.jax_diffvc import fwd_diffusion_from_jax
from tpu_speech_torch.compat.jax_spiral import load_jax_npz
from tpu_speech_torch.configs import diffvc as params
from tpu_speech_torch.data.diffvc import VCDecBatchCollate, VCDecDataset
from tpu_speech_torch.data.loader import DataLoader
from tpu_speech_torch.models.diffvc import DiffVC
from tpu_speech_torch.train.diffvc import DiffVCTrainer, dec_train_step, make_dec_preview
from tpu_speech_torch.parallel import distributed, launch
from tpu_speech_torch.utils.device import resolve_device
from tpu_speech_torch.utils.exp_manager import ExpManager


def load_encoder_params(enc_path: str) -> Dict[str, torch.Tensor]:
    """A stage-1 checkpoint -> the encoder's (``FwdDiffusion``'s)
    reference-named state_dict (``cli/train_dec.py::load_encoder_params:23``)."""
    if os.path.isdir(enc_path):
        raise NotImplementedError(
            f"{enc_path}: orbax checkpoints are not ported (ROADMAP.md, Queue 1); pass the "
            "encoder's .pt state_dict or an .npz of its JAX params")
    if enc_path.endswith(".npz"):
        return fwd_diffusion_from_jax(load_jax_npz(enc_path, ("params",))[0], params.layers)
    return torch.load(enc_path, map_location="cpu", weights_only=True)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--val-file", default=None)
    ap.add_argument("--exc-file", default=None)
    ap.add_argument("--enc-ckpt", required=True,
                    help="stage-1 encoder checkpoint (.pt state_dict or .npz of JAX params)")
    ap.add_argument("--log-dir", default="logs/dec")
    ap.add_argument("--epochs", type=int, default=110)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--precision", default="fp32", choices=["fp32", "bf16"],
                    help="bf16: the forward and backward on bf16 copies of the float32 "
                         "parameters")
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device; 'cpu' runs on the CPU")
    return ap


def main(argv=None, _init_method=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    args = build_parser().parse_args(argv)
    spawned, out = launch.launch(main, argv, args.device, _init_method, modules=(params,))
    if spawned:
        return out
    device = distributed.rank_device(resolve_device(args.device))
    launch.check_batch(args.batch_size)

    dataset = VCDecDataset(args.data_dir, args.val_file, args.exc_file,
                           shuffle_seed=params.seed)
    collate = VCDecBatchCollate(params.train_frames, params.n_mels, params.seed)
    loader = DataLoader(dataset, args.batch_size, collate, shuffle=True, num_workers=4,
                        seed=params.seed)

    torch.manual_seed(params.seed)
    model = DiffVC(**params.model_kwargs())
    model.encoder.load_state_dict(load_encoder_params(args.enc_ckpt), strict=True)
    model.to(device)
    n_params = sum(p.numel() for p in model.parameters())
    launch.say(f"Number of parameters = {n_params / 1e6:.2f}m")

    exp = ExpManager(name="diffvc_dec", explicit_log_dir=args.log_dir)
    exp.save_config(vars(args))
    # the preview's crops draw from a collate of their own, not the loader's
    preview_batch = VCDecBatchCollate(params.train_frames, params.n_mels, params.seed)(
        [dataset[i] for i in range(min(2, len(dataset)))])
    trainer = DiffVCTrainer(model, dec_train_step, args.log_dir, args.lr, seed=params.seed,
                            exp=exp, preview_fn=make_dec_preview(
                                preview_batch, sample_rate=params.sampling_rate,
                                images=images_available()), bf16=args.precision == "bf16")
    res = trainer.fit(loader, args.epochs)
    res["state_dict"] = trainer.save_state_dict("diffvc")
    res["n_params"] = n_params
    launch.say(f"saved model: {res['state_dict']}")
    exp.close()
    return res


if __name__ == "__main__":
    main()
