"""PyTorch port, the HiFi-GAN generator: the port against the JAX package.

At ``tests/test_hifigan_parity.py``'s small config (the V1 topology at 64
channels), resblock "1" and "2", on the same numpy mels, with weights
carried both ways: the port's ``state_dict`` through the JAX package's
``convert_generator``, and JAX-initialised trees through the port's
``hifigan_from_jax``. Tolerance 2e-5, the JAX package's own
(``test_hifigan_parity.py:65-85``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_speech.compat.torch_hifigan import convert_generator
from tpu_speech.models.hifigan import Generator as JGenerator
from tpu_speech_torch.compat.jax_gradtts import fold_weight_norm, hifigan_from_jax
from tpu_speech_torch.models.hifigan import Generator, to_int16_pcm

SMALL = dict(
    upsample_rates=(8, 8, 2, 2),
    upsample_kernel_sizes=(16, 16, 4, 4),
    upsample_initial_channel=64,
    resblock_kernel_sizes=(3, 7, 11),
)
DILATIONS = {"1": ((1, 3, 5),) * 3, "2": ((1, 3),) * 3}


def _cfg(resblock):
    return dict(SMALL, resblock=resblock, resblock_dilation_sizes=DILATIONS[resblock])


def _port_generator(resblock, seed):
    """The port's generator with every weight and bias uniform in
    +-1/sqrt(fan_in) from a seeded generator (outputs of order one, where
    the reference's normal(0, 0.01) init gives near-silence)."""
    gen = Generator(**_cfg(resblock)).eval()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in gen.modules():
            if isinstance(m, (torch.nn.Conv1d, torch.nn.ConvTranspose1d)):
                fan_in, _ = torch.nn.init._calculate_fan_in_and_fan_out(m.weight)
                for p in (m.weight, m.bias):
                    p.copy_((torch.rand(p.shape, generator=g) * 2 - 1) * fan_in ** -0.5)
    return gen


def _mel(rng, t=23):
    return (rng.standard_normal((1, t, 80)) * 0.5).astype(np.float32)


def _jax_wav(resblock, params, mel):
    return np.asarray(jax.jit(JGenerator(**_cfg(resblock)).apply)(params, jnp.asarray(mel)))


@pytest.mark.parametrize("resblock", ["1", "2"])
def test_generator_matches_jax(rng, resblock):
    gen = _port_generator(resblock, seed=0)
    mel = _mel(rng)
    params = convert_generator(gen.state_dict(), SMALL["upsample_rates"],
                               SMALL["resblock_kernel_sizes"], resblock)
    wav_j = _jax_wav(resblock, params, mel)
    with torch.no_grad():
        wav_t = gen(torch.tensor(mel).transpose(1, 2))
    assert wav_t.shape == (1, 1, 23 * 256) and wav_j.shape == (1, 23 * 256)
    assert np.abs(wav_j).max() > 0.1
    np.testing.assert_allclose(wav_t[:, 0].numpy(), wav_j, rtol=0, atol=2e-5)


@pytest.mark.parametrize("resblock", ["1", "2"])
def test_jax_initialised_generator_through_hifigan_from_jax(rng, resblock):
    """JAX's own init -> hifigan_from_jax -> a strict load; same waveform;
    and back through convert_generator leaf for leaf."""
    mel = _mel(rng, 11)
    jg = JGenerator(**_cfg(resblock))
    params = jax.tree.map(np.asarray, jax.jit(jg.init)(jax.random.PRNGKey(3),
                                                        jnp.asarray(mel)))
    sd = hifigan_from_jax(params)
    gen = Generator(**_cfg(resblock)).eval()
    gen.load_state_dict(sd, strict=True)
    with torch.no_grad():
        wav_t = gen(torch.tensor(mel).transpose(1, 2))
    np.testing.assert_allclose(wav_t[:, 0].numpy(), _jax_wav(resblock, params, mel),
                               rtol=0, atol=2e-5)
    back = convert_generator(sd, SMALL["upsample_rates"], SMALL["resblock_kernel_sizes"],
                             resblock)
    flat = jax.tree_util.tree_leaves_with_path
    for (pa, a), (pb, b) in zip(flat(params), flat(back)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)


def _weight_norm_state_dict(gen, rng):
    """A reference training checkpoint's generator: weight_g/weight_v pairs
    (v random, g the per-row norms the reference stores, times a random
    gain) and plain biases."""
    out = {}
    for k, v in gen.state_dict().items():
        if k.endswith(".weight"):
            p = k[: -len(".weight")]
            wv = torch.tensor(rng.standard_normal(tuple(v.shape)).astype(np.float32))
            out[f"{p}.weight_v"] = wv
            norm = wv.norm(dim=tuple(range(1, wv.dim())), keepdim=True)
            out[f"{p}.weight_g"] = norm * torch.tensor(
                rng.uniform(0.5, 1.5, size=tuple(norm.shape)).astype(np.float32))
        else:
            out[k] = v
    return out


def test_weight_norm_fold_matches_jax(rng):
    """fold_weight_norm against the JAX converter's own fold
    (torch_hifigan.py:23-31) on weight_g/weight_v pairs, ConvTranspose1d
    included (its norm runs over dims 1 and 2 too); the folded generator
    gives JAX's waveform."""
    gen = _port_generator("1", seed=1)
    wn = _weight_norm_state_dict(gen, rng)
    folded = fold_weight_norm(wn)
    assert not any(k.endswith(("_g", "_v")) for k in folded)
    params = convert_generator(wn, SMALL["upsample_rates"], SMALL["resblock_kernel_sizes"], "1")
    back = hifigan_from_jax(params)
    assert sorted(back) == sorted(folded)
    for k, v in folded.items():
        torch.testing.assert_close(back[k], v, rtol=1e-6, atol=1e-7)
    gen.load_state_dict(folded, strict=True)
    mel = _mel(rng, 11)
    with torch.no_grad():
        wav_t = gen(torch.tensor(mel).transpose(1, 2))
    np.testing.assert_allclose(wav_t[:, 0].numpy(), _jax_wav("1", params, mel), rtol=0,
                               atol=2e-5)


def test_full_width_v1_param_count_equals_jax():
    shapes = jax.eval_shape(lambda: JGenerator().init(jax.random.PRNGKey(0),
                                                       jnp.zeros((1, 32, 80))))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in Generator().parameters()) == n_jax


def test_int16_pcm_matches_the_jax_cli():
    """clip to [-1, 1], x 32767, truncate toward zero (cli/inference.py:157-160)."""
    wav = np.array([-1.5, -1.0, -0.99999, -0.5, -1e-6, 0.0, 3e-5, 0.25, 0.99999, 1.0, 2.0],
                   np.float32)
    ref = np.asarray((jnp.clip(jnp.asarray(wav), -1.0, 1.0) * 32767.0).astype(jnp.int16))
    got = to_int16_pcm(torch.tensor(wav))
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), ref)
