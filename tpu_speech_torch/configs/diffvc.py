"""DiffVC configuration: the port's copy of ``cli/params_vc.py``'s values
(the reference DiffVC/params.py surface).

The any-to-any voice-conversion model: an average-voice encoder of 192
channels and 6 layers, a conditional U-Net of dims (256, 512, 1024), 80 mels
at 22 050 Hz with hop 256.
"""

# data parameters
n_mels = 80
sampling_rate = 22050
n_fft = 1024
hop_size = 256

# "average voice" encoder parameters
channels = 192
filters = 768
layers = 6
kernel = 3
dropout = 0.1
heads = 2
window_size = 4
enc_dim = 128

# diffusion-based decoder parameters
dec_dim = 256
spk_dim = 128
use_ref_t = True
beta_min = 0.05
beta_max = 20.0

# training parameters
seed = 37
test_size = 1
train_frames = 128


def model_kwargs() -> dict:
    """``DiffVC``'s arguments at this configuration."""
    return dict(n_feats=n_mels, channels=channels, filters=filters, heads=heads,
                layers=layers, kernel=kernel, dropout=dropout, window_size=window_size,
                enc_dim=enc_dim, spk_dim=spk_dim, use_ref_t=use_ref_t, dec_dim=dec_dim,
                beta_min=beta_min, beta_max=beta_max)
