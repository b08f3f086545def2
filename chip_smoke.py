#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py

Drives the port's SPIRAL-base CTC transcription path once through its normal
entry point, at full width with seeded random weights, and checks each hand
kernel against its plain PyTorch version. Phases (any failure raises and the
script exits non-zero without printing a result):

1. build the CUDA kernels from ``tpu_speech_torch/csrc`` (nvcc, sm_90a);
2. K1 (fused log-mel) against ``logmel_plain`` at the SPIRAL shape
   (14 x 384 512 featurizer-input samples) and at frame-count edges;
3. K2 (merged-qkv attention forward) against ``qkv_attention_plain`` at both
   SPIRAL blocks' shapes, lengths over 30-100 % of T, one fully padded row;
4. the slice: synthetic wavs + manifest -> ``tpu_speech_torch.cli.run_spiral
   .main(--run_mode test)`` with full-width weights from a seeded
   ``torch.Generator``; the launch counters must show K1 on every batch and
   K2 twelve times per batch, and the log-probs must be finite;
5. the same weights on the CPU (plain paths) against the card's log-probs
   for two of those utterances;
6. timings with CUDA events (median of 20 after warm-up): each kernel beside
   its plain version, and the slice per batch.

Output: phase lines, then the card's name and power limit
(``nvidia-smi --query-gpu=name,power.limit``), then one JSON line describing
the kernels, then the last line ``{"ok": true, "device": {...}}``.
Needs one CUDA card; fails without one.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SR = 16000
BATCH = 14
MAX_SAMPLES = 24 * SR
N_UTTS = 28
# log-mel units. Both fp32 versions round the DFT differently (a product
# here, cuFFT in the plain version); the log amplifies that in frames where a
# one-bin low mel filter sees near-zero power. On this speech-like input
# either version lands within ~1.4e-4 of the float64 value.
K1_ATOL_PLAIN32 = 2e-4
K1_ATOL_PLAIN64 = 2e-4
K2_ATOL = 1e-4
SLICE_ATOL = 5e-3
SLICE_ARGMAX_AGREE = 0.99


def log(msg):
    print(msg, flush=True)


def check(ok, msg):
    if not ok:
        raise AssertionError(msg)


def speech_like(rng, n):
    """Voiced-speech stand-in: a gliding f0 (100-250 Hz) with 1/h harmonics
    up to 3.4 kHz under a 4 Hz syllable envelope, plus noise 40 dB below
    the 0.15 peak."""
    t = np.arange(n) / SR
    f0 = rng.uniform(100, 250) * (1 + 0.1 * np.sin(2 * np.pi * rng.uniform(0.2, 1) * t))
    phase = 2 * np.pi * np.cumsum(f0) / SR
    y = np.zeros(n)
    for h in range(1, int(3400 / 250) + 1):
        y += np.sin(h * phase + rng.uniform(0, 2 * np.pi)) / h
    env = 0.5 * (1 + np.sin(2 * np.pi * 4 * t + rng.uniform(0, 2 * np.pi))) ** 2
    y = 0.15 * y * env / np.abs(y).max()
    y += 0.0015 * rng.standard_normal(n)
    return y.astype(np.float32)


def cuda_ms(fn, n=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def phase_build(_build):
    t0 = time.perf_counter()
    _build.library()
    secs = time.perf_counter() - t0
    log(f"[1 build] {secs:.1f} s, compiled={_build.build_info['compiled']} "
        f"-> {_build.build_info['path']}")
    for line in _build.build_info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"    ptxas: {line.strip()}")


def phase_k1(torch, rng):
    from tpu_speech_torch.audio.mel import mel_filterbank
    from tpu_speech_torch.models.spiral.features import hann_window_symmetric, stft_input
    from tpu_speech_torch.ops.fused_logmel import fused_logmel, logmel_plain

    dev = "cuda"
    win = np.zeros(512, np.float32)
    win[96:416] = hann_window_symmetric(320)
    window = torch.tensor(win, device=dev)
    fb = torch.tensor(mel_filterbank(SR, 512, 128, 0.0, SR / 2), device=dev)
    lens = np.linspace(0.3, 1.0, BATCH) * MAX_SAMPLES
    wav = np.zeros((BATCH, MAX_SAMPLES), np.float32)
    for i, n in enumerate(lens.astype(int)):
        wav[i, :n] = speech_like(rng, n)
    # the signal K1 reads on the main path: normalized, preemphasized,
    # reflect-padded (14, 384 512)
    x = stft_input(torch.tensor(wav, device=dev), 512)
    worst = {}
    cases = [("spiral", x)] + [
        (f"frames={nf}", x[:3, : (nf - 1) * 160 + 512].contiguous())
        for nf in (1, 15, 16, 17, 33)  # tile of 16 frames: edge -1/0/+1, ragged
    ]
    for name, xx in cases:
        nf = 1 + (xx.shape[1] - 512) // 160
        kw = dict(n_fft=512, hop_length=160, num_frames=nf)
        out = fused_logmel(xx, window, fb, **kw)
        p32 = logmel_plain(xx, window, fb, **kw)
        p64 = logmel_plain(xx.double(), window.double(), fb.double(), **kw)
        torch.cuda.synchronize()
        check(out.shape == p32.shape and bool(torch.isfinite(out).all()), f"K1 {name}: bad output")
        e32 = (out - p32).abs().max().item()
        e64 = (out.double() - p64).abs().max().item()
        p_e64 = (p32.double() - p64).abs().max().item()
        log(f"[2 K1 {name}] shape {tuple(out.shape)}: max|K1-plain32| {e32:.3e}, "
            f"max|K1-plain64| {e64:.3e} (plain32 itself: {p_e64:.3e} off plain64)")
        check(e32 <= K1_ATOL_PLAIN32, f"K1 {name}: {e32} > {K1_ATOL_PLAIN32} vs plain fp32")
        check(e64 <= K1_ATOL_PLAIN64, f"K1 {name}: {e64} > {K1_ATOL_PLAIN64} vs plain fp64")
        worst[name] = e32
    kw = dict(n_fft=512, hop_length=160, num_frames=1 + (x.shape[1] - 512) // 160)
    return {
        "max_abs_err": max(worst.values()),
        "ms": cuda_ms(lambda: fused_logmel(x, window, fb, **kw)),
        "plain_ms": cuda_ms(lambda: logmel_plain(x, window, fb, **kw)),
        "shape": f"wav {tuple(x.shape)} -> {(BATCH, kw['num_frames'], 128)}",
    }


def phase_k2(torch, gen):
    from tpu_speech_torch.ops.fused_attention import (
        fused_qkv_self_attention,
        qkv_attention_plain,
    )

    dev = "cuda"
    res = {}
    for t, e, h in ((604, 512, 8), (302, 768, 12)):
        qkv = torch.randn(BATCH, t, 3 * e, generator=gen).to(dev)
        qkv[..., :e] *= (e // h) ** -0.5  # the folded q scale
        lens = torch.linspace(0.3 * t, t, BATCH).round().long().to(dev)
        lens[0] = 0  # one fully padded row
        mask = torch.arange(t, device=dev)[None, :] >= lens[:, None]
        out = fused_qkv_self_attention(qkv, h, mask)
        ref = qkv_attention_plain(qkv, h, mask)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        log(f"[3 K2 T={t} E={e} H={h}] max|K2-plain| {err:.3e}, fully padded "
            f"row finite: {bool(torch.isfinite(out[0]).all())}")
        check(bool(torch.isfinite(out).all()), f"K2 T={t}: non-finite output")
        check(err <= K2_ATOL, f"K2 T={t}: {err} > {K2_ATOL}")
        res[t] = dict(
            err=err,
            ms=cuda_ms(lambda: fused_qkv_self_attention(qkv, h, mask)),
            plain_ms=cuda_ms(lambda: qkv_attention_plain(qkv, h, mask)),
        )
        log(f"    K2 {res[t]['ms']:.3f} ms, plain {res[t]['plain_ms']:.3f} ms")
    return {
        "max_abs_err": max(r["err"] for r in res.values()),
        "ms": res[604]["ms"],
        "plain_ms": res[604]["plain_ms"],
        "shape": f"qkv (14, 604, 1536) H=8; at (14, 302, 2304) H=12: "
                 f"{res[302]['ms']:.4f} ms vs plain {res[302]['plain_ms']:.4f} ms",
    }


def write_corpus(root, rng):
    import scipy.io.wavfile

    words = ["speech", "model", "port", "kernel", "test", "audio", "hello", "world"]
    durations = np.linspace(3.0, 24.0, N_UTTS)
    rng.shuffle(durations)
    manifest = os.path.join(root, "test.json")
    with open(manifest, "w") as f:
        for i, d in enumerate(durations):
            path = os.path.join(root, f"utt{i:02d}.wav")
            pcm = np.clip(speech_like(rng, int(d * SR)) * 32767, -32768, 32767)
            scipy.io.wavfile.write(path, SR, pcm.astype(np.int16))
            text = " ".join(rng.choice(words, size=3))
            f.write(json.dumps({"audio_filepath": path, "duration": float(d),
                                "text": text}) + "\n")
    return manifest


def phase_slice(torch, rng, root):
    from tpu_speech_torch.cli import run_spiral
    from tpu_speech_torch.configs.spiral import spiral_base_ctc_char
    from tpu_speech_torch.ops import _build
    from tpu_speech_torch.train.spiral_runner import build_model

    manifest = write_corpus(root, rng)
    model = build_model(spiral_base_ctc_char(), num_classes=28)
    model.init_weights(torch.Generator().manual_seed(1234))
    n_params = sum(p.numel() for p in model.parameters())
    ckpt = os.path.join(root, "spiral_base_ctc_char.pt")
    torch.save(model.state_dict(), ckpt)
    del model
    run_dir = os.path.join(root, "run")
    argv = ["--config_name", "spiral_base_finetune_ls100_char",
            "--run_mode", "test", "--test_manifest", manifest,
            "--model_save_dir", run_dir, "--init_chkpt_dir", root,
            "--init_chkpt_file", os.path.basename(ckpt), "--save_logits", "true"]
    _build.reset_launches()
    t0 = time.perf_counter()
    results = run_spiral.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    n_batches = -(-N_UTTS // BATCH)
    log(f"[4 slice] {n_params / 1e6:.1f} M params, {results['n']} utts in "
        f"{n_batches} batches, {wall:.1f} s through run_spiral.main (model "
        f"build, 0.4 GB weight load, data, decode); "
        f"launches {launches}; WER {results['wer']:.3f} (random weights)")
    check(results["n"] == N_UTTS, f"decoded {results['n']} of {N_UTTS} utterances")
    check(launches["fused_logmel"] >= n_batches, f"K1 launches {launches}")
    check(launches["fused_qkv_attention"] == 12 * n_batches, f"K2 launches {launches}")
    logits = [np.load(os.path.join(run_dir, "logits", f"logits_{BATCH * (i + 1)}.npy"))
              for i in range(n_batches)]
    for lp in logits:
        check(lp.shape == (BATCH, 1208, 29), f"log-probs shape {lp.shape}")
        check(bool(np.isfinite(lp).all()), "non-finite log-probs")
    return manifest, ckpt, logits[0], launches


def load_batch(manifest, n):
    """The first n manifest utterances as the CLI batches them: float32 in
    [-1, 1), zero-padded to 24 s."""
    import scipy.io.wavfile

    with open(manifest) as f:
        entries = [json.loads(line) for line in f][:n]
    wavs = np.zeros((n, MAX_SAMPLES), np.float32)
    lens = np.zeros((n,), np.int32)
    for i, e in enumerate(entries):
        _, pcm = scipy.io.wavfile.read(e["audio_filepath"])
        wavs[i, :len(pcm)] = pcm.astype(np.float32) / 32768.0
        lens[i] = len(pcm)
    return wavs, lens


def load_model(torch, ckpt, device):
    from tpu_speech_torch.configs.spiral import spiral_base_ctc_char
    from tpu_speech_torch.train.spiral_runner import build_model

    cfg = spiral_base_ctc_char()
    model = build_model(cfg, num_classes=28)
    model.load_state_dict(torch.load(ckpt, map_location="cpu", weights_only=True))
    return cfg.model.encoder, model.to(device).eval()


def infer(torch, enc_cfg, model, wavs, lens):
    from tpu_speech_torch.models.spiral.st2vec import wav_to_spec

    with torch.inference_mode():
        return model(*wav_to_spec(enc_cfg, wavs, lens))


def phase_cpu_vs_card(torch, manifest, ckpt, card_logits):
    enc_cfg, model = load_model(torch, ckpt, "cpu")
    wavs, lens = load_batch(manifest, 2)
    lp, out_lens = infer(torch, enc_cfg, model, torch.tensor(wavs), torch.tensor(lens))
    worst, agree, total = 0.0, 0, 0
    for i in range(2):
        n = int(out_lens[i])
        cpu, card = lp[i, :n].numpy(), card_logits[i, :n]
        worst = max(worst, float(np.abs(cpu - card).max()))
        agree += int((cpu.argmax(-1) == card.argmax(-1)).sum())
        total += n
    share = agree / total
    log(f"[5 cpu vs card] 2 utts, {total} valid frames: max|card-cpu| "
        f"{worst:.3e} (limit {SLICE_ATOL}), argmax agreement {share:.4f}")
    check(worst <= SLICE_ATOL, f"card vs CPU log-probs differ by {worst}")
    check(share >= SLICE_ARGMAX_AGREE, f"argmax agreement {share}")


def phase_slice_time(torch, manifest, ckpt):
    enc_cfg, model = load_model(torch, ckpt, "cuda")
    wavs, lens = load_batch(manifest, BATCH)
    wavs, lens = torch.tensor(wavs, device="cuda"), torch.tensor(lens, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: infer(torch, enc_cfg, model, wavs, lens), n=10)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[6 slice time] wav (14, 384000) on the card -> log-probs: {ms:.2f} ms "
        f"per batch (median of 10), peak device memory {peak:.2f} GiB")
    profile_slice(torch, lambda: infer(torch, enc_cfg, model, wavs, lens))


def profile_slice(torch, run, batches=3, top=8):
    """Where the slice's device time goes: torch.profiler kernel events over a
    few batches, summed by kernel name, and the device's busy share of the
    span from the first kernel's start to the last kernel's end (kernels
    cuDNN overlaps count once in the share, fully in the per-kernel sums)."""
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(batches):
            run()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        log("[6 profile] the profiler saw no device kernels; not measured")
        return
    busy, (cur_s, cur_e) = 0, spans[0]
    by_name = defaultdict(lambda: [0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name][0] += e.time_range.end - e.time_range.start
            by_name[e.name][1] += 1
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0]
    log(f"[6 profile] {len(spans) // batches} kernels per batch; device busy "
        f"{busy / batches / 1e3:.2f} ms of a {span / batches / 1e3:.2f} ms span per "
        f"batch (share {busy / span:.3f})")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"    {us / batches / 1e3:8.3f} ms  x{n // batches:<3d} {name[:90]}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on a GPU only",
              file=sys.stderr)
        return 2
    from tpu_speech_torch.ops import _build
    from tpu_speech_torch.train.spiral_runner import use_full_fp32

    use_full_fp32()
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    phase_build(_build)
    k1 = phase_k1(torch, rng)
    log(f"    K1 {k1['ms']:.3f} ms, plain {k1['plain_ms']:.3f} ms")
    k2 = phase_k2(torch, gen)
    with tempfile.TemporaryDirectory() as root:
        manifest, ckpt, card_logits, launches = phase_slice(torch, rng, root)
        phase_cpu_vs_card(torch, manifest, ckpt, card_logits)
        phase_slice_time(torch, manifest, ckpt)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kernels = [
        dict(name="fused_logmel", route="cuda",
             source="tpu_speech_torch/csrc/fused_logmel.cu",
             replaces="tpu_speech/ops/fused_logmel.py:203",
             launches=launches["fused_logmel"], **k1),
        dict(name="fused_qkv_self_attention", route="cuda",
             source="tpu_speech_torch/csrc/fused_attention.cu",
             replaces="tpu_speech/ops/fused_attention.py:384",
             launches=launches["fused_qkv_attention"], **k2),
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
