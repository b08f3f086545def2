"""SPIRAL launcher for the port: ST2Vec pretraining, CTC finetuning and CTC
transcription.

Port of ``cli/run_spiral.py``, with its defaults
(``--model_type spiral --run_mode train --resume_if_exists true``, the run
directory ``--model_save_dir``, else ``--log_dir``, else ``logs/spiral``) and
every one of its flags:

- ``--model_type spiral|st2vec`` (``:312-346``): the pretrain loop of
  ``SpiralPretrainRunner`` for ``trainer.max_epochs`` epochs (``--max_epochs``)
  or until ``trainer.max_steps`` updates, validation every
  ``trainer.val_check_interval_epochs`` epochs (the contrastive loss and the
  collapse diagnostics in ``train.log``), a step checkpoint after every
  epoch, then the reference-named ``<run dir>/st2vec.pt`` and the archive
  ``<run dir>/<cfg.name>.tpu_speech``::

    python -m tpu_speech_torch.cli.run_spiral \\
        --config_name spiral_base_pretrain_ls960 --manifest_dir D \\
        --set trainer.max_steps=N --model_save_dir OUT

- ``--model_type ctc_finetune --run_mode train`` (``:348-447``): the
  encoder from ``--init_chkpt_dir/--init_chkpt_file`` (a pretraining
  state_dict such as ``st2vec.pt``, a step checkpoint, a reference
  checkpoint, an archive, or JAX trees in an ``.npz``;
  ``--use_teacher_encoder`` takes the EMA teacher's) unless
  ``--finetune_from_scratch true``; the finetune loop with validation (WER)
  and a step checkpoint after every epoch, stopping at ``trainer.max_steps``;
  then ``<run dir>/ctc_finetune.pt`` and the archive::

    python -m tpu_speech_torch.cli.run_spiral --model_type ctc_finetune \\
        --config_name spiral_base_finetune_ls100_char --manifest_dir D \\
        --init_chkpt_dir PRE --init_chkpt_file st2vec.pt \\
        --set trainer.max_steps=N --model_save_dir OUT

- ``--model_type ctc_finetune --run_mode test`` (``:348-430``): build the
  configured model, load test weights (``--init_chkpt_dir/--init_chkpt_file``:
  a reference-named ``.pt``, a step checkpoint, a ``.tpu_speech`` archive or
  an ``.npz``; or ``--init_archive``), decode the test manifest (greedily, or
  by prefix beam search with ``--beam_size`` > 1, shallow-fused with an n-gram
  LM of ``--lm_order`` fit on ``--lm_manifest``'s transcripts in the model's
  id space at ``--lm_alpha``) and print ``TEST: WER = ... | CER = ... | N
  utts``::

    python -m tpu_speech_torch.cli.run_spiral --model_type ctc_finetune \\
        --run_mode test --config_name spiral_large_finetune_ls100_subword \\
        --tokenizer_file vocab.tsv --beam_size 16 --lm_manifest train.json \\
        --lm_order 4 --lm_alpha 0.5 --test_manifest test.json \\
        --model_save_dir logs/test --init_archive OUT/ctc_finetune.tpu_speech

  ``--tokenizer_file`` (both finetune modes) is a subword vocab file
  (``piece\\tscore`` lines, ``text/tokenizers.py::SubwordTokenizer``), else
  the config's char labels are the targets.

Resume: a second run in the same run directory (or ``--chkpt_dir``) starts
from the latest step checkpoint, at the epoch after it, and equals a run that
was never stopped where the step is deterministic (on the CPU; on the card
with ``torch.backends.cudnn.deterministic = True``, which this CLI leaves
off); ``--resume_if_exists false`` starts afresh. Explicit test
weights turn resume off. A checkpoint directory that holds only the JAX
package's orbax steps stops the run (orbax imports JAX).

Weights: ``--init_archive`` (all three modes) loads a ``.tpu_speech`` archive
that either package wrote, strictly, or partially with ``--init_model_partial
true``, leaving out the flax paths that contain a ``--load_model_skip_var``
pattern; ``--use_chkpt_hparams true`` takes the model config from the
archive.

Configs (``:190-240``): ``--config_name`` is a key of
``tpu_speech_torch.configs.spiral.CONFIGS`` (the JAX experiment files'
names), or a YAML experiment file (``NAME.yaml``, as a path or under
``--config_path``; ``--structured_config false`` requires
``<config_path>/<name>.yaml``; a ``<config_path>/<name>.yaml`` that exists is
taken first) whose ``base:`` is a key of ``CONFIGS`` and whose other keys
override its leaves (``utils/config.py::load_yaml_experiment``). The JAX
CLI imports ``base`` from its python config modules, which import JAX; the
port resolves it against ``CONFIGS``. ``--manifest_dir`` (else
``--data_dir``) rebases the configured manifests' file names onto a
directory (``:270-277``); ``--set KEY=VALUE`` overrides a config leaf
(``:148-153``); both train modes take ``--set model.precision=bf16`` and
``--set trainer.accumulate_grad_batches=N``. ``--profile true`` traces the
first epoch with ``torch.profiler`` into ``<run dir>/plugins``.
``--device`` (the port's own flag) defaults to ``cuda`` and fails without a
card.

``--streaming_eval true`` (test mode, ``:393-396``) decodes the test manifest
through the chunk-incremental transcriber of a streaming-mode config
(``spiral_base_finetune_ls100_char_streaming``, ``spiral_tiny_stream_test``;
``SpiralFinetuneRunner.evaluate_streaming``) and prints ``TEST (streaming):
WER = ... | CER = ... | N utts``.

Several devices (``:169-190``, ``parallel/``), one process a card: every
mode runs data-parallel, the training steps equal to one process's on the
global batch of ``batch_size x ranks``.

- ``--num_devices N`` (``--num_gpus``) starts N local ranks; 0, the default,
  means every visible card (one process on a one-card machine; with
  ``--device cpu``, one process, and N means N gloo ranks). On one node they
  meet at a ``file://`` store in a temporary directory::

    python -m tpu_speech_torch.cli.run_spiral --num_devices 4 \
        --config_name spiral_base_pretrain_ls960 --manifest_dir D \
        --model_save_dir OUT

- Several nodes: ``--num_nodes M --node_rank K --master_addr HOST[:PORT]``
  (or the reference's environment: MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
  NODE_RANK), with ``--num_devices N`` ranks a node; ``torchrun
  --nproc_per_node N -m tpu_speech_torch.cli.run_spiral ...`` works too
  (RANK, LOCAL_RANK, WORLD_SIZE). The process group is joined before any
  device is used, then ``--num_nodes`` is checked (``require_multiprocess``).
- ``--fsdp true`` shards the parameters and AdamW's moments over the ranks
  (FSDP2, ``parallel/mesh.py::shard_state_fsdp``), also in a one-process run.

- ``--seq_parallel S`` (pretraining) splits the ranks into a (data, seq)
  mesh of world / S data groups of S ranks each: a data group's ranks hold
  the same rows and each runs the encoders on T / S frames of them
  (``parallel/seq.py``); the step stays the one-process step on the global
  batch of ``batch_size x world / S``. The finetune mode raises, as the JAX
  runner does::

    python -m tpu_speech_torch.cli.run_spiral --num_devices 4 --seq_parallel 2 \
        --config_name spiral_base_pretrain_ls960 --manifest_dir D --model_save_dir OUT

``--export_model PATH`` (test mode) saves the wav -> log-probs graph after
the evaluation as a ``torch.export`` program
(``SpiralFinetuneRunner.export_model``), which
``utils/export.py::load_exported`` runs. ``--use_horovod`` warns and
``--test_mode`` is ignored, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import os
import sys

import torch

from tpu_speech_torch.configs.spiral import CONFIGS
from tpu_speech_torch.data.spiral import read_manifest
from tpu_speech_torch.eval.ctc_beam import NGramLM
from tpu_speech_torch.parallel import distributed, launch
from tpu_speech_torch.text.tokenizers import CharTokenizer, SubwordTokenizer
from tpu_speech_torch.train.spiral_runner import (
    SEQ_FINETUNE,
    SpiralFinetuneRunner,
    SpiralPretrainRunner,
)
from tpu_speech_torch.utils.archive import config_object, read_config
from tpu_speech_torch.utils.config import (
    apply_override,
    apply_overrides,
    load_yaml_experiment,
    parse_cli_override,
)
from tpu_speech_torch.utils.exp_manager import ExpManager
from tpu_speech_torch.utils.profiling import trace
from tpu_speech_torch.utils.surgery import parse_skip_vars

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
    """The JAX CLI's flags (``cli/run_spiral.py:33-154``) with its defaults,
    and ``--device``."""
    p = argparse.ArgumentParser(
        description="SPIRAL pretraining, CTC finetuning and CTC transcription "
                    "(PyTorch port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--data_dir", type=str, default="",
                   help="dataset path: the manifests' directory when --manifest_dir is unset")
    p.add_argument("--manifest_dir", type=str, default="",
                   help="directory the configured manifest file names live in")
    p.add_argument("--model_save_dir", type=str, default="",
                   help="run dir (falls back to --log_dir, then logs/spiral)")
    p.add_argument("--tensorboard_dir", type=str, default="",
                   help="TensorBoard dir; default: the run dir")
    p.add_argument("--log_dir", type=str, default="",
                   help="the run dir when --model_save_dir is unset")
    p.add_argument("--chkpt_dir", type=str, default="",
                   help="step checkpoint dir; default: <run dir>/ckpt")
    p.add_argument("--config_path", type=str, default="conf/spiral",
                   help="directory of YAML experiment files (<name>.yaml); their "
                   "base: and --config_name are keys of "
                   "tpu_speech_torch.configs.spiral.CONFIGS")
    p.add_argument("--config_name", type=str, required=True,
                   help=f"a YAML experiment file or one of {', '.join(sorted(CONFIGS))}")
    p.add_argument("--structured_config", type=str2bool, default=True,
                   help="false: the config is the YAML file <config_path>/<name>.yaml")
    p.add_argument("--num_devices", type=int, default=0,
                   help="local ranks, one card each (0 = every visible card; with "
                   "--device cpu, 0 = one process and N = N gloo ranks)")
    p.add_argument("--num_gpus", type=int, default=0, help="alias of --num_devices")
    p.add_argument("--use_horovod", type=str2bool, default=False,
                   help="accepted for launch-script parity; warns")
    p.add_argument("--test_mode", type=str, default="multi_gpu",
                   help="accepted and ignored, as in the JAX CLI")
    p.add_argument("--seq_parallel", type=int, default=0,
                   help="pretraining: shard the encoders' time axis over groups of this "
                   "many ranks (the world must divide by it)")
    p.add_argument("--fsdp", type=str2bool, default=False,
                   help="shard the parameters and optimizer state over the ranks (FSDP2)")
    p.add_argument("--num_nodes", type=int, default=1,
                   help="hosts in the run; more than 1 needs MASTER_ADDR/MASTER_PORT/"
                   "WORLD_SIZE/NODE_RANK or --master_addr/--node_rank")
    p.add_argument("--node_rank", type=int, default=-1,
                   help="this host's rank (overrides NODE_RANK)")
    p.add_argument("--master_addr", type=str, default="",
                   help="coordinator host[:port] (overrides MASTER_ADDR)")
    p.add_argument("--resume_if_exists", type=str2bool, default=True,
                   help="continue from the run's latest step checkpoint")
    p.add_argument("--run_mode", type=str, default="train", choices=["train", "test"])
    p.add_argument("--init_chkpt_dir", type=str, default="")
    p.add_argument("--init_chkpt_file", type=str, default="",
                   help="checkpoint name within --init_chkpt_dir; a '*' glob must "
                   "match exactly one path")
    p.add_argument("--init_model_partial", type=str2bool, default=False,
                   help="allow a partial weight load from --init_archive or the test "
                   "weights: matching paths and shapes load, the rest keep their init")
    p.add_argument("--use_chkpt_hparams", type=str2bool, default=False,
                   help="take cfg.model from --init_archive's config")
    p.add_argument("--load_model_skip_var", type=str, default="",
                   help="comma-separated substrings; flax paths that contain one are "
                   "not loaded from --init_archive or the test weights")
    p.add_argument("--init_archive", type=str, default="",
                   help="restore weights from a .tpu_speech archive (all three modes)")
    p.add_argument("--test_manifest", type=str, default="")
    p.add_argument("--model_type", type=str, default="spiral",
                   choices=["spiral", "st2vec", "ctc_finetune"],
                   help="spiral and st2vec both pretrain")
    p.add_argument("--finetune_from_scratch", type=str2bool, default=False,
                   help="finetune train mode: keep the random encoder init")
    p.add_argument("--use_teacher_encoder", type=str2bool, default=False,
                   help="finetune train mode: take the pretraining EMA teacher's encoder")
    p.add_argument("--save_logits", type=str2bool, default=False,
                   help="save each batch's log-probs under <run dir>/logits")
    p.add_argument("--streaming_eval", type=str2bool, default=False,
                   help="test mode: decode chunk by chunk (a streaming-mode config)")
    p.add_argument("--beam_size", type=int, default=1,
                   help="test mode: 1 = greedy decoding, more = CTC prefix beam search")
    p.add_argument("--lm_manifest", type=str, default="",
                   help="beam search: fit an n-gram LM on this manifest's transcripts")
    p.add_argument("--lm_alpha", type=float, default=0.5, help="the LM's fusion weight")
    p.add_argument("--lm_order", type=int, default=4, help="the LM's n-gram order")
    p.add_argument("--export_model", type=str, default="",
                   help="test mode: save the wav -> log-probs graph as a torch.export "
                   ".pt2 at this path (utils/export.py)")
    p.add_argument("--tokenizer_file", type=str, default="",
                   help="ctc_finetune: a subword vocab file (piece<TAB>score lines); "
                   "default: the config's char labels")
    p.add_argument("--max_epochs", type=int, default=0,
                   help="overrides trainer.max_epochs when > 0")
    p.add_argument("--dev_data_dup_factor", type=int, default=0,
                   help="duplicate validation entries N times")
    p.add_argument("--profile", type=str2bool, default=False,
                   help="trace the first training epoch with torch.profiler into "
                   "<run dir>/plugins")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="dotted config override, e.g. --set trainer.max_steps=3 "
                   "(repeatable)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs the plain versions")
    return p


def _config(name: str):
    """A fresh RunConfig of ``CONFIGS[name]``; SystemExit for a name the
    port does not have."""
    if name not in CONFIGS:
        raise SystemExit(f"config {name!r}: the port's configs are "
                         f"{', '.join(sorted(CONFIGS))}")
    return CONFIGS[name]()


def load_config(args):
    """The run config of ``--config_name`` (``cli/run_spiral.py:190-240``): a
    YAML experiment file (a path, or under ``--config_path``), composed from
    its ``base:`` config and its overrides, or a key of ``CONFIGS``."""
    yaml_path = None
    cand = os.path.join(args.config_path, args.config_name + ".yaml")
    if args.config_name.endswith((".yaml", ".yml")):
        yaml_path = (args.config_name if os.path.isfile(args.config_name)
                     else os.path.join(args.config_path, args.config_name))
    elif not args.structured_config:
        if not os.path.isfile(cand):
            raise SystemExit(f"--structured_config=false but no YAML config at {cand}")
        yaml_path = cand
    elif os.path.isfile(cand):
        yaml_path = cand
    if yaml_path is None:
        return _config(args.config_name)
    base, overrides = load_yaml_experiment(yaml_path)
    cfg = _config(base)
    apply_overrides(cfg, overrides)
    return cfg


def _epochs(cfg, runner, profile: bool):
    """Each epoch of this run (from the one after the last checkpointed one):
    train, validate when due, checkpoint; yields (epoch, loss, validation).
    ``profile`` traces the first."""
    max_steps = cfg.trainer.max_steps
    val_every = max(1, getattr(cfg.trainer, "val_check_interval_epochs", 1))
    first = runner.epoch + 1
    for epoch in range(first, cfg.trainer.max_epochs + 1):
        if max_steps and runner.iteration >= max_steps:
            break
        ctx = trace(runner.log_dir) if profile and epoch == first else contextlib.nullcontext()
        with ctx:
            loss = runner.train_epoch(epoch, max_steps)
        val = runner.validate() if epoch % val_every == 0 else None
        runner.save_checkpoint(epoch)
        yield epoch, loss, val


def _finish(runner, out: dict) -> dict:
    runner.ckpt.wait()  # drain the last checkpoint write
    out["state_dict"] = runner.save_state_dict()
    launch.say(f"saved model state_dict: {out['state_dict']}")
    out["archive"] = runner.save_archive()
    launch.say(f"saved model archive: {out['archive']}")
    out.update(steps=runner.history, iteration=runner.iteration, epoch=runner.epoch,
               log_dir=runner.log_dir)
    return out


def train_st2vec(cfg, runner: SpiralPretrainRunner, profile: bool = False) -> dict:
    """The pretrain loop (cli/run_spiral.py:324-346)."""
    loss, val = float("nan"), {}
    for _, loss, v in _epochs(cfg, runner, profile):
        if v is not None and v == v:  # validation_ds configured and not empty
            val = runner.last_validation
            launch.say(f"Validation: loss = {v:.4f}", flush=True)
    return _finish(runner, {"loss": loss, "validation": val})


def train_ctc(cfg, runner: SpiralFinetuneRunner, profile: bool = False) -> dict:
    """The finetune loop (cli/run_spiral.py:431-447)."""
    loss, val = float("nan"), {}
    for _, loss, v in _epochs(cfg, runner, profile):  # train_epoch prints the epoch's line
        if v:
            val = v
            launch.say(f"Validation: WER = {v['wer']:.4f} | CER = {v['cer']:.4f}", flush=True)
    return _finish(runner, {"loss": loss, "validation": val})


def main(argv=None, _init_method=None) -> dict:
    parser = build_parser()
    argv = sys.argv[1:] if argv is None else argv
    args = parser.parse_args(args=argv)
    if args.seq_parallel > 1 and args.model_type == "ctc_finetune":
        raise ValueError(SEQ_FINETUNE)  # before test mode makes its run directory
    # --num_devices (or --num_gpus) ranks on this node, 0 meaning every
    # visible card (one process on the CPU)
    spawned, out = launch.launch(main, argv, args.device, _init_method,
                                 n=args.num_devices or args.num_gpus,
                                 master_addr=args.master_addr, num_nodes=args.num_nodes,
                                 node_rank=args.node_rank)
    if spawned:
        return out
    if args.use_horovod:
        launch.say("WARNING: --use_horovod requested; NCCL collectives through torch.distributed "
             "are the port's only backend, so the flag is accepted for launch-script "
             "parity and has no effect (the lr rescale counts the ranks).", file=sys.stderr)
    run_dir = args.model_save_dir or args.log_dir or "logs/spiral"
    skip_vars = parse_skip_vars(args.load_model_skip_var)

    cfg = load_config(args)
    for spec in args.overrides:
        apply_override(cfg, *parse_cli_override(spec))
    if args.use_chkpt_hparams:
        # the model config from the archive (cli/run_spiral.py:241-268); the
        # dataset paths are rewired from the command line below
        if not args.init_archive:
            raise SystemExit("--use_chkpt_hparams requires --init_archive")
        model_cfg = getattr(config_object(read_config(args.init_archive)), "model", None)
        if model_cfg is None or isinstance(model_cfg, dict):
            raise SystemExit("--use_chkpt_hparams: the archive's config has no model "
                             "section to rebuild")
        cfg.model = model_cfg
        launch.say(f"model hparams taken from the archive config ({args.init_archive})")
    manifest_dir = args.manifest_dir or args.data_dir
    if manifest_dir:
        for ds in (cfg.model.train_ds, cfg.model.validation_ds, cfg.model.test_ds):
            if ds is not None:
                ds.manifest_filepath = ",".join(
                    p if os.path.isabs(p) else os.path.join(manifest_dir, os.path.basename(p))
                    for p in ds.manifest_filepath.split(","))
    if args.test_manifest and cfg.model.test_ds is not None:
        cfg.model.test_ds.manifest_filepath = args.test_manifest
    if args.max_epochs:
        cfg.trainer.max_epochs = args.max_epochs
    if args.seq_parallel:
        cfg.trainer.seq_parallel = args.seq_parallel
    if args.fsdp:
        cfg.trainer.fsdp = True
    if args.dev_data_dup_factor > 0 and cfg.model.validation_ds is not None:
        cfg.model.validation_ds.dup_factor = args.dev_data_dup_factor

    exp = ExpManager(name=cfg.exp_manager.name or args.config_name, explicit_log_dir=run_dir,
                     resume_if_exists=args.resume_if_exists,
                     tensorboard_dir=args.tensorboard_dir or None)
    exp.save_config(cfg)
    try:
        return _run(args, cfg, exp, run_dir, skip_vars)
    finally:
        exp.close()  # flush TensorBoard before a spawned rank exits


def _run(args, cfg, exp, run_dir, skip_vars) -> dict:
    """The mode the flags ask for, from a loaded config."""
    if args.model_type in ("spiral", "st2vec"):
        if args.run_mode != "train":
            raise SystemExit(f"--model_type {args.model_type} runs --run_mode train")
        runner = SpiralPretrainRunner(cfg, run_dir, device=args.device, exp=exp,
                                      ckpt_dir=args.chkpt_dir)
        if args.init_archive:
            runner.restore_from_archive(args.init_archive, partial=args.init_model_partial,
                                        skip=skip_vars)
            launch.say(f"Restored weights from archive: {args.init_archive}")
        if args.resume_if_exists and runner.resume_if_exists():
            launch.say(f"Resumed from iteration {runner.iteration} (epoch {runner.epoch})")
        return train_st2vec(cfg, runner, profile=args.profile)

    if args.run_mode == "train":
        if (not args.finetune_from_scratch and args.init_chkpt_dir
                and args.init_chkpt_file):
            cfg.model.pretrain_chkpt_path = get_ckpt_path(args.init_chkpt_dir,
                                                          args.init_chkpt_file)
    else:
        # test weights come from --init_*; an archive's config may name the
        # encoder file of the run that trained it
        cfg.model.pretrain_chkpt_path = None
    cfg.model.use_teacher_encoder = args.use_teacher_encoder
    if args.tokenizer_file:
        tokenizer = SubwordTokenizer(args.tokenizer_file)
    elif cfg.model.labels is None:
        raise SystemExit(f"{args.config_name} has subword targets "
                         f"({cfg.model.tokenizer_file}): pass --tokenizer_file")
    else:
        tokenizer = CharTokenizer(cfg.model.labels)
    runner = SpiralFinetuneRunner(cfg, run_dir, tokenizer, device=args.device, exp=exp,
                                  ckpt_dir=args.chkpt_dir)
    if cfg.model.pretrain_chkpt_path:
        launch.say(f"Loaded the pretrained encoder from: {cfg.model.pretrain_chkpt_path}")
    if args.init_archive:
        runner.restore_from_archive(args.init_archive, partial=args.init_model_partial,
                                    skip=skip_vars)
        launch.say(f"Restored weights from archive: {args.init_archive}")
    resume = args.resume_if_exists
    if args.run_mode == "test" and args.init_chkpt_dir and args.init_chkpt_file:
        path = get_ckpt_path(args.init_chkpt_dir, args.init_chkpt_file)
        runner.restore_from_checkpoint(path, partial=args.init_model_partial, skip=skip_vars)
        launch.say(f"Loaded test-mode weights from: {path}")
        resume = False  # explicit test weights take priority over a run's checkpoints
    if resume and runner.resume_if_exists():
        launch.say(f"Resumed from iteration {runner.iteration} (epoch {runner.epoch})")
    if args.run_mode == "train":
        return train_ctc(cfg, runner, profile=args.profile)
    if args.streaming_eval:
        results = runner.evaluate_streaming()
        launch.say(f"TEST (streaming): WER = {results['wer']:.4f} | CER = {results['cer']:.4f} "
              f"| {results['n']} utts")
        return results

    lm = None
    if args.beam_size > 1 and args.lm_manifest:
        # shallow fusion: the n-gram LM in the model's id space, blank offset
        # included (cli/run_spiral.py:402-416)
        texts = [e["text"] for e in read_manifest(args.lm_manifest, 0.0, None)]
        lm = NGramLM.from_texts(texts, runner.tokenizer, order=args.lm_order)
        launch.say(f"n-gram LM (order {args.lm_order}) fit on {len(texts)} transcripts")
    results = runner.evaluate(
        save_logits_dir=os.path.join(runner.log_dir, "logits") if args.save_logits else None,
        beam_width=args.beam_size, lm=lm, lm_alpha=args.lm_alpha,
    )
    launch.say(f"TEST: WER = {results['wer']:.4f} | CER = {results['cer']:.4f} "
          f"| {results['n']} utts")
    launch.say(f"per-utterance diagnosis: {results['diagnosis_html']}")
    if distributed.process_count() > 1:
        print(f"rank {results['rank']}: decoded {len(results['hyps'])} utts in "
              f"{results['decode_s']:.3f} s", flush=True)
    if args.export_model and distributed.is_primary():
        results["exported"] = runner.export_model(args.export_model)
        launch.say(f"exported: {results['exported']}")
    return results


if __name__ == "__main__":
    main()
