"""SPIRAL launcher for the port: the CTC ``--run_mode test`` path.

Port of ``cli/run_spiral.py`` for ``--model_type ctc_finetune --run_mode
test``: build the configured model, load test weights, decode the test
manifest greedily and print ``TEST: WER = ... | CER = ... | N utts``.

    python -m tpu_speech_torch.cli.run_spiral --run_mode test \\
        --config_name spiral_base_finetune_ls100_char \\
        --test_manifest test.json --model_save_dir logs/test \\
        --init_chkpt_dir ckpts --init_chkpt_file model.pt   # or .npz

Weights: a torch state_dict with the reference names (``.pt``), or the JAX
package's trees in an ``.npz`` (``params/...``, ``batch_stats/...``; see
``tpu_speech_torch/compat/jax_spiral.py``). Without weights the model keeps
its seeded random init. ``--config_name`` is a key of
``tpu_speech_torch.configs.spiral.CONFIGS`` (char-label recipes).

Not ported yet: pretraining and finetune training, YAML configs and
``--set`` overrides, subword tokenizers, archives, beam search, streaming
evaluation, export and multi-node runs.
"""

from __future__ import annotations

import argparse
import glob
import os

from tpu_speech.text.tokenizers import CharTokenizer
from tpu_speech_torch.configs.spiral import CONFIGS
from tpu_speech_torch.train.spiral_runner import SpiralFinetuneRunner


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
        description="SPIRAL CTC transcription (PyTorch port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--config_name", type=str, required=True,
                   choices=sorted(CONFIGS))
    p.add_argument("--model_type", type=str, default="ctc_finetune",
                   choices=["ctc_finetune"])
    p.add_argument("--run_mode", type=str, default="test", choices=["test"])
    p.add_argument("--test_manifest", type=str, default="")
    p.add_argument("--model_save_dir", type=str, default="")
    p.add_argument("--log_dir", type=str, default="")
    p.add_argument("--init_chkpt_dir", type=str, default="")
    p.add_argument("--init_chkpt_file", type=str, default="")
    p.add_argument("--save_logits", type=str2bool, default=False,
                   help="save each batch's log-probs under <run dir>/logits")
    p.add_argument("--device", type=str, default="",
                   help="torch device (default: cuda when available)")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(args=argv)
    cfg = CONFIGS[args.config_name]()
    if args.test_manifest:
        cfg.model.test_ds.manifest_filepath = args.test_manifest
    log_dir = args.model_save_dir or args.log_dir or "logs/spiral_torch"

    runner = SpiralFinetuneRunner(cfg, log_dir, CharTokenizer(cfg.model.labels),
                                  device=args.device or None)
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
