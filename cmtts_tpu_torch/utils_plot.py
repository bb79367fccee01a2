# Copied from cmtts_tpu/utils_plot.py (jax-free; matplotlib imported on use).
"""Figure helpers (reference ``utils/tools.py:610-687`` plot_mel family)."""

from __future__ import annotations

import os

import numpy as np


def plot_mel(mel: np.ndarray, path: str, title: str = "Synthesized mel") -> None:
    """Save a mel-spectrogram image (mel: (T, n_mels))."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 3))
    im = ax.imshow(np.asarray(mel).T, origin="lower", aspect="auto",
                   interpolation="none")
    ax.set_title(title)
    ax.set_xlabel("frames")
    ax.set_ylabel("mel bins")
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    fig.savefig(path, dpi=80)
    plt.close(fig)


def mel_comparison_figure(gt_mel: np.ndarray, syn_mel: np.ndarray,
                          title: str = "mel"):
    """GT-vs-synthesized mel comparison figure for TB logging (reference
    ``utils/tools.py:610-648`` synth-sample plotting).  Returns the
    matplotlib figure (caller logs/closes it); mels are (T, n_mels)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 1, figsize=(10, 5), sharex=True)
    for ax, mel, name in ((axes[0], gt_mel, "ground truth"),
                          (axes[1], syn_mel, "one-step synthesis")):
        im = ax.imshow(np.asarray(mel).T, origin="lower", aspect="auto",
                       interpolation="none")
        ax.set_title(f"{title} — {name}", fontsize=9)
        ax.set_ylabel("mel bins")
        fig.colorbar(im, ax=ax)
    axes[1].set_xlabel("frames")
    fig.tight_layout()
    return fig


def contour_comparison_figure(target: np.ndarray, pred: np.ndarray,
                              title: str, ylabel: str):
    """Target-vs-predicted 1-D track (f0 / energy) for TB logging
    (reference ``f0_to_figure`` / ``energy_to_figure``,
    utils/tools.py:650-687).  Returns the matplotlib figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 3))
    ax.plot(np.asarray(target), color="tab:blue", lw=1.0, label="target")
    ax.plot(np.asarray(pred), color="tab:red", lw=1.0, alpha=0.8,
            label="predicted")
    ax.set_title(title, fontsize=9)
    ax.set_xlabel("frames")
    ax.set_ylabel(ylabel)
    ax.legend(fontsize=8)
    fig.tight_layout()
    return fig


def load_speaker_embeddings(embedding_dir: str):
    """Gather per-speaker embedding npy files written by the preprocessor
    (``{speaker}-spker_embed.npy``) -> (embeddings (N, D), speaker ids)
    (reference ``preprocessor/preprocessor.py:461-470``)."""
    import glob

    rows, ids = [], []
    for path in sorted(glob.glob(os.path.join(embedding_dir, "*.npy"))):
        emb = np.load(path).reshape(-1)
        rows.append(emb)
        ids.append(os.path.basename(path).split("-")[0])
    if not rows:
        return np.zeros((0, 0)), []
    return np.stack(rows), ids


def speaker_gender_map(corpus_dir: str, dataset: str) -> dict:
    """Speaker id -> 'M'/'F' from the corpus metadata (reference
    ``preprocessor/preprocessor.py:439-459``): VCTK ``speaker-info.txt``
    column 3, LibriTTS ``speakers.tsv`` READER/GENDER columns; LJSpeech is
    single-speaker (empty map)."""
    import csv
    import re

    speakers: dict = {}
    if dataset == "VCTK":
        path = os.path.join(corpus_dir, "speaker-info.txt")
        if os.path.isfile(path):
            with open(path, encoding="utf-8") as f:
                for line in f:
                    if "ID" in line:
                        continue
                    parts = [p.strip() for p in
                             re.sub(" +", " ", line.strip()).split(" ")]
                    if len(parts) >= 3:
                        speakers[str(parts[0])] = parts[2]
    elif dataset == "LibriTTS":
        path = os.path.join(os.path.dirname(corpus_dir), "speakers.tsv")
        if os.path.isfile(path):
            with open(path, encoding="utf-8") as f:
                for row in csv.DictReader(f, delimiter="\t"):
                    speakers[str(row["READER"])] = str(row["GENDER"])
    return speakers


def plot_embedding(out_dir: str, embedding: np.ndarray, speaker_ids,
                   gender_dict: dict, filename: str = "spker_embed_tsne.png"):
    """t-SNE scatter of speaker embeddings colored by gender (reference
    ``utils/tools.py:630-648``); falls back to PCA when the corpus has too
    few speakers for a meaningful perplexity."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(embedding)
    if n == 0:
        return None
    data_y = np.array([gender_dict.get(s) == "M" for s in speaker_ids], int)
    if n > 3:
        from sklearn.manifold import TSNE

        perplexity = min(30.0, max(2.0, (n - 1) / 3))
        pts = TSNE(n_components=2, random_state=0, init="random",
                   perplexity=perplexity).fit_transform(embedding)
    else:  # t-SNE needs perplexity < n; tiny corpora get a PCA projection
        centered = embedding - embedding.mean(0)
        _, _, vt = np.linalg.svd(centered, full_matrices=False)
        pts = centered @ vt[:2].T if vt.shape[0] >= 2 else np.concatenate(
            [centered @ vt[:1].T, np.zeros((n, 1))], axis=1)
    plt.figure(figsize=(10, 10))
    for val, c, label in ((0, "r", "Female"), (1, "b", "Male")):
        sel = data_y == val
        if sel.any():
            plt.scatter(pts[sel, 0], pts[sel, 1], c=c, label=label, alpha=0.5)
    plt.grid(True)
    plt.legend(loc="upper left")
    plt.tight_layout()
    path = os.path.join(out_dir, filename)
    plt.savefig(path)
    plt.close()
    return path
