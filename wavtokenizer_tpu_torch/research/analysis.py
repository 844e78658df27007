"""Host-side analysis: t-SNE projections, speaker clustering and similarity.

The port's own copy of ``wavtokenizer_tpu/research/analysis.py`` (ref
tsne.py / add.py: combined t-SNE of clean against enhanced features across
materials; tr_encodec.py:264-344: k-means speaker clustering of pooled
features; recon.py:95-165: speaker similarity against training centroids).
numpy, with sklearn (TSNE, KMeans) and matplotlib imported only by the
functions that need them.
"""

from __future__ import annotations

import numpy as np


def pool_features(features: np.ndarray, time_axis: int | None = None) -> np.ndarray:
    """(B, D, T) or (B, T, D) -> (B, D) mean-pooled embeddings.

    Pass ``time_axis`` (1 or 2) explicitly when known; the heuristic
    (time = the longer trailing axis) misfires on clips shorter than D
    frames."""
    f = np.asarray(features)
    if f.ndim != 3:
        raise ValueError(f.shape)
    if time_axis is None:
        time_axis = 2 if f.shape[2] >= f.shape[1] else 1
    if time_axis not in (1, 2):
        raise ValueError(time_axis)
    return f.mean(axis=time_axis)


def tsne_project(embeddings: np.ndarray, perplexity: float = 30.0,
                 seed: int = 0) -> np.ndarray:
    """(N, D) -> (N, 2) t-SNE projection (tsne.py / add.py plots)."""
    from sklearn.manifold import TSNE
    x = np.asarray(embeddings)
    n = len(x)
    perplexity = min(perplexity, max(2.0, (n - 1) / 3.0))
    # barnes_hut segfaults on tiny inputs (single-core sklearn build) and
    # its O(N log N) approximation only pays off at scale; use the exact
    # gradient below a few hundred points.
    method = "exact" if n < 500 else "barnes_hut"
    # PCA init divides by the total variance; degenerate (near-identical)
    # embeddings — e.g. an untrained model collapsing to one code — would
    # turn the whole projection into NaNs.
    init = "pca" if float(x.var(axis=0).sum()) > 1e-12 else "random"
    return TSNE(n_components=2, perplexity=perplexity, init=init,
                method=method, random_state=seed).fit_transform(x)


def kmeans_clusters(embeddings: np.ndarray, n_clusters: int, seed: int = 0):
    """Speaker k-means (tr_encodec.py:264-344).  Returns (labels, centroids)."""
    from sklearn.cluster import KMeans
    km = KMeans(n_clusters=n_clusters, random_state=seed, n_init=10)
    labels = km.fit_predict(np.asarray(embeddings))
    return labels, km.cluster_centers_


def speaker_similarity(embedding: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    """Cosine similarity of one embedding against speaker centroids
    (recon.py:95-165).  Returns (n_speakers,) scores."""
    e = embedding / (np.linalg.norm(embedding) + 1e-9)
    c = centroids / (np.linalg.norm(centroids, axis=1, keepdims=True) + 1e-9)
    return c @ e


def plot_tsne(points: np.ndarray, labels, out_path: str, title: str = "t-SNE"):
    """Scatter plot colored by label (add.py:354-443 style)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    labels = np.asarray(labels)
    fig, ax = plt.subplots(figsize=(8, 6))
    for lab in np.unique(labels):
        m = labels == lab
        ax.scatter(points[m, 0], points[m, 1], s=12, label=str(lab), alpha=0.7)
    ax.set_title(title)
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path
