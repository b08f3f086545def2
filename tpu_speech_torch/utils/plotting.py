"""Mel and alignment images: the port's own copy of ``plot_tensor`` and
``save_plot`` of ``tpu_speech/utils/plotting.py`` (the reference
Grad-TTS/utils.py helpers behind the per-epoch TensorBoard images,
train.py:89-172). ``matplotlib`` is imported at the call."""

from __future__ import annotations

import numpy as np


def _figure(tensor):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    arr = np.asarray(tensor)
    if arr.ndim == 2 and arr.shape[0] > arr.shape[1]:
        arr = arr.T  # frequency on y
    fig, ax = plt.subplots(figsize=(12, 3))
    im = ax.imshow(arr, aspect="auto", origin="lower", interpolation="none")
    fig.colorbar(im, ax=ax)
    return plt, fig


def plot_tensor(tensor) -> np.ndarray:
    """Render a (T, F) or (F, T) array to an HWC uint8 image."""
    plt, fig = _figure(tensor)
    fig.canvas.draw()
    data = np.asarray(fig.canvas.buffer_rgba())[:, :, :3].copy()
    plt.close(fig)
    return data


def save_plot(tensor, savepath: str) -> None:
    plt, fig = _figure(tensor)
    fig.tight_layout()
    fig.savefig(savepath)
    plt.close(fig)
