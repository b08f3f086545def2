"""PyTorch port, Conformer-CTC against the JAX package on the CPU: the
relative positional table and ``_rel_shift`` bit for bit, the rel-pos
attention with and without a mask, ``ConformerCTCModel`` from specs and from
wavs, the padding invariance, the converters both ways, and three train
steps with AdamW and the global-norm clip.

Sizes are ``tests/test_conformer.py``'s ``CFG`` (d_model 32, 2 heads, 2
layers, kernel 7); the weights are JAX's init moved off it by a seeded
perturbation and converted by ``compat/jax_ctc_models.py``; dropout is off.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_speech.models.spiral import conformer as jcf
from tpu_speech.nn import conformer_attention as jca
from tpu_speech_torch.compat.jax_ctc_models import conformer_ctc_from_jax, conformer_ctc_to_jax
from tpu_speech_torch.models.spiral import conformer as pcf
from tpu_speech_torch.nn import conformer_attention as pca

from tests.test_conformer import CFG
from tests.test_torch_jasper import (
    FWD_RTOL,
    _np,
    assert_close_scaled,
    check_train_steps,
    check_wav_path,
    ctc_batch,
    jit_apply,
    jit_init,
    perturbed,
    specs_batch,
)

jax.config.update("jax_default_matmul_precision", "highest")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch (the suite's six workers share the
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_cfg(jcfg):
    return pcf.ConformerConfig(**dataclasses.asdict(jcfg))


@pytest.mark.parametrize("length,d_model", [(1, 8), (5, 8), (16, 32), (151, 176)])
def test_rel_positional_encoding_and_shift_are_jax_bit_for_bit(length, d_model):
    table = pca.rel_positional_encoding(length, d_model)
    np.testing.assert_array_equal(table, jca.rel_positional_encoding(length, d_model))
    assert table.dtype == np.float32 and table.shape == (2 * length - 1, d_model)
    x = np.random.default_rng(length).standard_normal((2, 3, length, 2 * length - 1))
    x = x.astype(np.float32)
    np.testing.assert_array_equal(pca._rel_shift(torch.tensor(x)).numpy(),
                                  np.asarray(jca._rel_shift(jnp.asarray(x))))
    assert pca._rel_shift(torch.tensor(x)).shape == (2, 3, length, length)


@pytest.mark.parametrize("masked", [False, True])
def test_rel_pos_attention_matches_jax(masked):
    """The u/v biases moved off zero; masked keys (a padded row's tail) get
    -1e9 before the softmax and 0 after it."""
    r = np.random.default_rng(2)
    x = r.standard_normal((2, 10, 16)).astype(np.float32)
    mask = np.zeros((2, 10, 10), bool)
    mask[1, :, 7:] = True
    jmask = jnp.asarray(mask) if masked else None
    attn = jca.RelPositionMultiHeadAttention(n_head=4, n_feat=16)
    params = perturbed(attn.init({"params": jax.random.PRNGKey(0)}, *(jnp.asarray(x),) * 3,
                                 jmask), 3)
    want = attn.apply(params, *(jnp.asarray(x),) * 3, jmask)
    port = pca.RelPositionMultiHeadAttention(4, 16)
    p = params["params"]
    sd = {f"{n}.{w}": torch.tensor(np.asarray(p[n]["kernel"]).T if w == "weight"
                                   else np.asarray(p[n]["bias"]))
          for n in ("linear_q", "linear_k", "linear_v", "linear_out") for w in ("weight", "bias")}
    sd["linear_pos.weight"] = torch.tensor(np.asarray(p["linear_pos"]["kernel"]).T)
    sd["pos_bias_u"] = torch.tensor(np.asarray(p["pos_bias_u"]))
    sd["pos_bias_v"] = torch.tensor(np.asarray(p["pos_bias_v"]))
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = port(*(torch.tensor(x),) * 3, torch.tensor(mask) if masked else None)
    assert_close_scaled(_np(got), want, FWD_RTOL)


def test_config_equals_jax():
    assert dataclasses.asdict(pcf.ConformerConfig(29)) == dataclasses.asdict(
        jcf.ConformerConfig(29))
    assert dataclasses.asdict(port_cfg(CFG)) == dataclasses.asdict(CFG)


@pytest.mark.parametrize("size", [64, 63, 13])
def test_same_pads_are_flax_same(size):
    """The stride-2 subsampling pads as flax's "SAME" does: (0, 1) on an
    even size, (1, 1) on an odd one, and the output size ceil(size / 2)."""
    x = np.random.default_rng(size).standard_normal((1, size, 5, 1)).astype(np.float32)
    conv = jax.numpy.ones((3, 3, 1, 1))
    want = jax.lax.conv_general_dilated(jnp.asarray(x), conv, (2, 2), "SAME",
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    pt, pf = pcf.same_pads(size, 3, 2), pcf.same_pads(5, 3, 2)
    assert pt == ((0, 1) if size % 2 == 0 else (1, 1))
    got = torch.nn.functional.conv2d(
        torch.nn.functional.pad(torch.tensor(x).permute(0, 3, 1, 2), pf + pt),
        torch.ones(1, 1, 3, 3), stride=2)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=1e-5)


@pytest.fixture(scope="module")
def tiny():
    specs, lens = specs_batch(0, 2, 64, CFG.n_mels, [64, 40])
    jmodel = jcf.ConformerCTCModel(CFG)
    variables = perturbed(jit_init(jmodel, specs, lens), 13)
    port = pcf.ConformerCTCModel(port_cfg(CFG), device="cpu")
    port.load_state_dict(conformer_ctc_from_jax(variables), strict=True)
    return jmodel, variables, port.eval()


def test_converters_round_trip_exactly(tiny):
    _, variables, port = tiny
    back = conformer_ctc_to_jax(conformer_ctc_from_jax(variables))
    assert jax.tree.structure(back) == jax.tree.structure(variables)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(a, b)
    again = conformer_ctc_from_jax(conformer_ctc_to_jax(port.state_dict()))
    for k, v in port.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(again[k], v, rtol=0, atol=0)


@pytest.mark.parametrize("t,lens", [(64, [64, 40]), (63, [9, 63])])
def test_forward_from_specs_matches_jax(tiny, t, lens):
    """Even and odd frame counts (the "SAME" pads differ), and a short row:
    log-probs within 5e-5 x max(1, max|JAX|), lengths (l + 1) // 2 twice."""
    jmodel, variables, port = tiny
    specs, lens = specs_batch(t, 2, t, CFG.n_mels, lens)
    want, want_lens = jit_apply(jmodel)(variables, jnp.asarray(specs), jnp.asarray(lens))
    with torch.no_grad():
        got, got_lens = port(torch.tensor(specs), torch.tensor(lens))
    assert got.shape == want.shape and port.blank_idx == jmodel.blank_idx == CFG.num_classes
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_array_equal(got_lens.numpy(), ((lens + 1) // 2 + 1) // 2)
    assert_close_scaled(_np(got), want, FWD_RTOL)


def test_forward_from_wavs_matches_jax(tiny):
    """Window 400 in n_fft 512, 16 mels: the plain K1 path against JAX's
    rfft path."""
    check_wav_path(*tiny, lens=(6400, 4100), n=6400)


def test_padding_invariance(tiny):
    """Garbage in the padded tail leaves the valid frames' log-probs as they
    were (``tests/test_conformer.py::test_padding_invariance``)."""
    _, _, port = tiny
    base = np.random.default_rng(1).standard_normal((1, 64, CFG.n_mels)).astype(np.float32)
    garbage = base.copy()
    garbage[0, 40:] = 77.0
    lens = torch.tensor([40])
    with torch.no_grad():
        a, out_lens = port(torch.tensor(base), lens)
        b, _ = port(torch.tensor(garbage), lens)
    v = int(out_lens[0])
    np.testing.assert_allclose(_np(a)[0, :v], _np(b)[0, :v], atol=2e-4, rtol=0)


def test_train_steps_match_jax(tiny):
    jmodel, variables, port = tiny
    batch = ctc_batch(31, 2, 64, CFG.n_mels, [64, 52], CFG.num_classes, [6, 4])
    check_train_steps(jmodel, variables, port, conformer_ctc_from_jax, batch)


def test_seeded_init_moves_every_weight_and_keeps_the_biases_zero():
    model = pcf.ConformerCTCModel(port_cfg(CFG), device="cpu")
    a = model.init_weights(torch.Generator().manual_seed(0)).state_dict()
    b = pcf.ConformerCTCModel(port_cfg(CFG), device="cpu").init_weights(
        torch.Generator().manual_seed(0)).state_dict()
    for k, v in a.items():
        torch.testing.assert_close(v, b[k], rtol=0, atol=0)
    layer = model.encoder.layers[0]
    assert not layer.self_attn.pos_bias_u.detach().any()
    assert float(layer.self_attn.linear_q.weight.detach().std()) > 0.05
    assert float(model.encoder.subsample[0].weight.detach().std()) > 0.2
