"""SPIRAL launcher for the port: ST2Vec pretraining, CTC finetuning and CTC
transcription.

Port of ``cli/run_spiral.py`` for three of its paths:

- ``--model_type st2vec --run_mode train`` (``:312-346``): the pretrain loop
  of ``SpiralPretrainRunner`` for ``trainer.max_epochs`` epochs or until
  ``trainer.max_steps`` steps, then the reference-named state_dict in
  ``<model_save_dir>/st2vec.pt``::

    python -m tpu_speech_torch.cli.run_spiral --model_type st2vec \\
        --run_mode train --config_name spiral_base_pretrain_ls960 \\
        --manifest_dir D --set trainer.max_steps=N --model_save_dir OUT

- ``--model_type ctc_finetune --run_mode train`` (``:348-447``): the
  encoder from ``--init_chkpt_dir/--init_chkpt_file`` (a pretraining
  state_dict such as ``st2vec.pt``, a reference checkpoint, or JAX trees in
  an ``.npz``; ``--use_teacher_encoder`` takes the EMA teacher's) unless
  ``--finetune_from_scratch true``; the finetune loop with validation every
  ``trainer.val_check_interval_epochs`` epochs, stopping at
  ``trainer.max_steps``; then ``<model_save_dir>/ctc_finetune.pt``::

    python -m tpu_speech_torch.cli.run_spiral --model_type ctc_finetune \\
        --run_mode train --config_name spiral_base_finetune_ls100_char \\
        --manifest_dir D --init_chkpt_dir PRE --init_chkpt_file st2vec.pt \\
        --set trainer.max_steps=N --model_save_dir OUT

- ``--model_type ctc_finetune --run_mode test``: build the configured model,
  load test weights, decode the test manifest greedily and print
  ``TEST: WER = ... | CER = ... | N utts``::

    python -m tpu_speech_torch.cli.run_spiral --run_mode test \\
        --config_name spiral_base_finetune_ls100_char \\
        --test_manifest test.json --model_save_dir logs/test \\
        --init_chkpt_dir ckpts --init_chkpt_file model.pt   # or .npz

Weights: a torch state_dict with the reference names (``.pt``), or the JAX
package's trees in an ``.npz`` (``params/...``, ``batch_stats/...``; see
``tpu_speech_torch/compat/jax_spiral.py``). Without weights the model keeps
its seeded random init. ``--config_name`` is a key of
``tpu_speech_torch.configs.spiral.CONFIGS``. ``--manifest_dir`` rebases the
configured manifests' file names onto a directory (``:270-277``); ``--set
KEY=VALUE`` overrides a config leaf (``:148-153``); both train modes take
``--set model.precision=bf16`` (bf16 mixed precision) and ``--set
trainer.accumulate_grad_batches=N`` (one update per N batches). ``--device``
defaults to ``cuda`` and fails without a card.

Not ported yet: resume, orbax checkpoints, ``.tpu_speech`` archives and
``--init_archive``, YAML configs, subword tokenizers, beam search, streaming
evaluation, export and multi-node runs.
"""

from __future__ import annotations

import argparse
import glob
import os

from tpu_speech_torch.configs.spiral import CONFIGS
from tpu_speech_torch.text.tokenizers import CharTokenizer
from tpu_speech_torch.train.spiral_runner import (
    SpiralFinetuneRunner,
    SpiralPretrainRunner,
)
from tpu_speech_torch.utils.config import apply_override, parse_cli_override


def str2bool(v):
    return str(v).lower() in ("true", "1", "yes")


def get_ckpt_path(ckpt_dir, ckpt_name):
    """Resolve a checkpoint name inside a dir; a '*' glob must match exactly
    one path."""
    path = os.path.join(ckpt_dir, ckpt_name)
    if "*" not in path:
        return path
    matches = glob.glob(path)
    if len(matches) != 1:
        raise ValueError(f"expect 1 ckpt file, but got {len(matches)}")
    return matches[0]


def build_parser():
    p = argparse.ArgumentParser(
        description="SPIRAL pretraining, CTC finetuning and CTC transcription "
                    "(PyTorch port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--config_name", type=str, required=True,
                   choices=sorted(CONFIGS))
    p.add_argument("--model_type", type=str, default="ctc_finetune",
                   choices=["st2vec", "ctc_finetune"])
    p.add_argument("--run_mode", type=str, default="test", choices=["train", "test"])
    p.add_argument("--manifest_dir", type=str, default="",
                   help="directory the configured manifest file names live in")
    p.add_argument("--test_manifest", type=str, default="")
    p.add_argument("--model_save_dir", type=str, default="")
    p.add_argument("--log_dir", type=str, default="")
    p.add_argument("--init_chkpt_dir", type=str, default="")
    p.add_argument("--init_chkpt_file", type=str, default="")
    p.add_argument("--finetune_from_scratch", type=str2bool, default=False,
                   help="finetune train mode: keep the random encoder init")
    p.add_argument("--use_teacher_encoder", type=str2bool, default=False,
                   help="finetune train mode: take the pretraining EMA teacher's "
                   "encoder")
    p.add_argument("--save_logits", type=str2bool, default=False,
                   help="save each batch's log-probs under <run dir>/logits")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs the plain versions")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="dotted config override, e.g. --set trainer.max_steps=3 "
                   "(repeatable)")
    return p


def train_st2vec(cfg, log_dir: str, device: str) -> dict:
    """The pretrain loop (cli/run_spiral.py:312-346 without validation,
    resume and archives)."""
    runner = SpiralPretrainRunner(cfg, log_dir, device=device)
    max_steps = cfg.trainer.max_steps
    loss = float("nan")
    for epoch in range(1, cfg.trainer.max_epochs + 1):
        loss = runner.train_epoch(epoch, max_steps)
        print(f"Epoch {epoch}: loss = {loss:.4f}", flush=True)
        if max_steps and runner.iteration >= max_steps:
            break
    path = runner.save_state_dict()
    print(f"saved model state_dict: {path}")
    return {"loss": loss, "steps": runner.history, "state_dict": path,
            "iteration": runner.iteration}


def train_ctc(cfg, runner: SpiralFinetuneRunner) -> dict:
    """The finetune loop (cli/run_spiral.py:431-447 without resume and
    archives)."""
    max_steps = cfg.trainer.max_steps
    val_every = max(1, getattr(cfg.trainer, "val_check_interval_epochs", 1))
    loss, val = float("nan"), {}
    for epoch in range(1, cfg.trainer.max_epochs + 1):
        loss = runner.train_epoch(epoch, max_steps)  # prints the epoch's line
        if epoch % val_every == 0:
            val = runner.validate()
            if val:
                print(f"Validation: WER = {val['wer']:.4f} | CER = {val['cer']:.4f}",
                      flush=True)
        if max_steps and runner.iteration >= max_steps:
            break
    path = runner.save_state_dict()
    print(f"saved model state_dict: {path}")
    return {"loss": loss, "steps": runner.history, "state_dict": path,
            "iteration": runner.iteration, "validation": val}


def main(argv=None) -> dict:
    args = build_parser().parse_args(args=argv)
    cfg = CONFIGS[args.config_name]()
    for spec in args.overrides:
        apply_override(cfg, *parse_cli_override(spec))
    if args.manifest_dir:
        for ds in (cfg.model.train_ds, cfg.model.validation_ds, cfg.model.test_ds):
            if ds is not None:
                ds.manifest_filepath = ",".join(
                    p if os.path.isabs(p) else os.path.join(args.manifest_dir,
                                                            os.path.basename(p))
                    for p in ds.manifest_filepath.split(","))
    if args.test_manifest:
        cfg.model.test_ds.manifest_filepath = args.test_manifest
    log_dir = args.model_save_dir or args.log_dir or "logs/spiral_torch"

    if args.model_type == "st2vec":
        if args.run_mode != "train":
            raise SystemExit("--model_type st2vec runs --run_mode train")
        return train_st2vec(cfg, log_dir, args.device)
    if (args.run_mode == "train" and not args.finetune_from_scratch
            and args.init_chkpt_dir and args.init_chkpt_file):
        cfg.model.pretrain_chkpt_path = get_ckpt_path(args.init_chkpt_dir,
                                                      args.init_chkpt_file)
    cfg.model.use_teacher_encoder = args.use_teacher_encoder
    runner = SpiralFinetuneRunner(cfg, log_dir, CharTokenizer(cfg.model.labels),
                                  device=args.device)
    if args.run_mode == "train":
        if cfg.model.pretrain_chkpt_path:
            print(f"Loaded the pretrained encoder from: {cfg.model.pretrain_chkpt_path}")
        return train_ctc(cfg, runner)
    if args.init_chkpt_dir and args.init_chkpt_file:
        path = get_ckpt_path(args.init_chkpt_dir, args.init_chkpt_file)
        runner.load_weights(path)
        print(f"Loaded test-mode weights from: {path}")

    results = runner.evaluate(
        save_logits_dir=os.path.join(log_dir, "logits") if args.save_logits else None,
    )
    print(f"TEST: WER = {results['wer']:.4f} | CER = {results['cer']:.4f} "
          f"| {results['n']} utts")
    print(f"per-utterance diagnosis: {results['diagnosis_html']}")
    return results


if __name__ == "__main__":
    main()
