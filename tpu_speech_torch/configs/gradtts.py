"""Grad-TTS configuration: the port's copy of ``cli/params.py``'s values
(the reference Grad-TTS/params.py surface). That module imports
``tpu_speech.ops.masks``, so the port keeps its own copy.

The LJSpeech model: 192 encoder channels, 6 layers, 2 heads, window 4,
dec_dim 64, 80 mels at 22 050 Hz with hop 256.
"""

from tpu_speech_torch.ops.masks import fix_len_compatibility

# data parameters
train_filelist_path = "resources/filelists/ljspeech/train.txt"
valid_filelist_path = "resources/filelists/ljspeech/valid.txt"
test_filelist_path = "resources/filelists/ljspeech/test.txt"
cmudict_path = "resources/cmu_dictionary"
add_blank = True
n_spks = 1  # 247 for Libri-TTS filelist and 1 for LJSpeech
spk_emb_dim = 64
n_feats = 80
n_fft = 1024
sample_rate = 22050
hop_length = 256
win_length = 1024
f_min = 0
f_max = 8000

# encoder parameters
n_enc_channels = 192
filter_channels = 768
filter_channels_dp = 256
n_enc_layers = 6
enc_kernel = 3
enc_dropout = 0.1
n_heads = 2
window_size = 4

# decoder parameters
dec_dim = 64
beta_min = 0.05
beta_max = 20.0
pe_scale = 1000  # 1 for old checkpoints

# training parameters
log_dir = "logs/new_exp"
test_size = 4
n_epochs = 10000
batch_size = 16
learning_rate = 1e-4
seed = 37
save_every = 1
precision = "fp32"
out_size = fix_len_compatibility(2 * 22050 // 256)

# inference parameters
y_max_length_bucket = 256  # the mel-length granularity of synthesis


def model_kwargs(n_vocab: int) -> dict:
    """``GradTTS``'s arguments at this configuration."""
    return dict(n_vocab=n_vocab, n_spks=n_spks, spk_emb_dim=spk_emb_dim,
                n_enc_channels=n_enc_channels, filter_channels=filter_channels,
                filter_channels_dp=filter_channels_dp, n_heads=n_heads,
                n_enc_layers=n_enc_layers, enc_kernel=enc_kernel, enc_dropout=enc_dropout,
                window_size=window_size, n_feats=n_feats, dec_dim=dec_dim,
                beta_min=beta_min, beta_max=beta_max, pe_scale=pe_scale)
