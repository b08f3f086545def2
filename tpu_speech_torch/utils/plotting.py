"""Mel, alignment and embedding images: the port's own copy of
``tpu_speech/utils/plotting.py`` (the reference Grad-TTS/utils.py helpers
behind the per-epoch TensorBoard images, train.py:89-172, and the GE2E
visualizer's projections, speaker_encoder/encoder/visualizations.py).
``matplotlib`` is imported at the call."""

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


# speaker colormap from the GE2E visualizer
# (DiffVC/speaker_encoder/encoder/visualizations.py:12-26 — constant table)
_SPEAKER_COLORMAP = np.array([
    [76, 255, 0], [0, 127, 70], [255, 0, 0], [255, 217, 38],
    [0, 135, 255], [165, 0, 165], [255, 167, 255], [0, 255, 255],
    [255, 96, 38], [142, 76, 0], [33, 0, 127], [0, 0, 0],
    [183, 183, 183],
], dtype=np.float64) / 255.0


def pca_project(x: np.ndarray, n_components: int = 2) -> np.ndarray:
    """(N, D) -> (N, n_components) principal-component projection (numpy SVD;
    replaces the reference's UMAP, which is unavailable offline)."""
    x = np.asarray(x, dtype=np.float64)
    x = x - x.mean(axis=0, keepdims=True)
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    return x @ vt[:n_components].T


def plot_projections(embeds: np.ndarray, utterances_per_speaker: int,
                     step: int, out_fpath: str | None = None,
                     max_speakers: int = 10) -> np.ndarray:
    """2-D projection scatter of utterance embeddings colored by speaker
    (draw_projections, visualizations.py:158-175). Returns the HWC uint8
    image; also saves it to ``out_fpath`` when given."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    max_speakers = min(max_speakers, len(_SPEAKER_COLORMAP))
    embeds = np.asarray(embeds)[: max_speakers * utterances_per_speaker]
    n_speakers = len(embeds) // utterances_per_speaker
    ground_truth = np.repeat(np.arange(n_speakers), utterances_per_speaker)
    colors = _SPEAKER_COLORMAP[ground_truth]

    projected = pca_project(embeds)
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.scatter(projected[:, 0], projected[:, 1], c=colors)
    ax.set_aspect("equal", "datalim")
    ax.set_title(f"PCA projection (step {step})")
    fig.canvas.draw()
    data = np.asarray(fig.canvas.buffer_rgba())[:, :, :3].copy()
    if out_fpath is not None:
        fig.savefig(out_fpath)
    plt.close(fig)
    return data
