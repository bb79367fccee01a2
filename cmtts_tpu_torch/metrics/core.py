# Copied from cmtts_tpu/metrics/core.py (jax-free) so that the port imports nothing of cmtts_tpu;
# gmm_kl and the transcriber fail closed with a message when their optional package is
# missing, a transcriber is a callable or a local model directory (nothing is downloaded),
# and speaker_cos without an embedder uses the port's GE2E on the card.
"""Pairwise metric implementations (reference ``all_metrics.py`` +
``metrics/``): MCD, F0-RMSE/corr, log-F0, FFE, SSIM, SI-SDR, mel-SDR,
mfcc-cos, GMM-KL, WER, FID, precision/recall, speaker-cos.
"""

from __future__ import annotations

import math
import os

import numpy as np

from cmtts_tpu_torch.metrics.dtw import align_by_path, dtw_cost, dtw_path
from cmtts_tpu_torch.metrics.features import (
    SR,
    load_wav,
    mcep,
    mcep_dctmel,
    mel_power,
    mfcc,
    trim_silence,
)
from cmtts_tpu_torch.metrics.yin import compute_yin


# -- f0 --------------------------------------------------------------------
def extract_f0(wav: np.ndarray, sr: int = SR, frame_period_ms: float = 5.0,
               f0_floor: float = 71.0, f0_ceil: float = 800.0) -> np.ndarray:
    """f0 track at 5 ms frames.  Reference uses pyworld.harvest
    (all_metrics.py:83-87); here the YIN tracker stands in."""
    hop = int(sr * frame_period_ms / 1000)
    f0, _, _, _ = compute_yin(wav, sr, w_len=4 * hop, w_step=hop,
                              f0_min=f0_floor, f0_max=f0_ceil)
    return f0


def aligned_voiced_f0(wav1: np.ndarray, wav2: np.ndarray, sr: int = SR):
    """Voiced-only DTW-aligned f0 pair (all_metrics.py:89-102)."""
    f0_1 = extract_f0(wav1, sr)
    f0_2 = extract_f0(wav2, sr)
    f0_1 = f0_1[f0_1 > 0]
    f0_2 = f0_2[f0_2 > 0]
    if len(f0_1) == 0 or len(f0_2) == 0:
        return np.zeros(0), np.zeros(0)
    path = dtw_path(f0_1[:, None], f0_2[:, None])
    a1 = f0_1[[p[0] for p in path]]
    a2 = f0_2[[p[1] for p in path]]
    return a1, a2


def f0_rmse(wav_syn: np.ndarray, wav_raw: np.ndarray, sr: int = SR) -> float:
    """Mean 1200*|log2 f0 ratio| in cents over aligned voiced frames
    (all_metrics.py:314-334)."""
    a1, a2 = aligned_voiced_f0(wav_syn, wav_raw, sr)
    if len(a1) == 0:
        return float("nan")
    return float(np.mean(1200 * np.abs(np.log2(a1) - np.log2(a2))))


def f0_corr(wav_syn: np.ndarray, wav_raw: np.ndarray, sr: int = SR) -> float:
    """Pearson correlation of aligned voiced f0 (all_metrics.py:306-312)."""
    a1, a2 = aligned_voiced_f0(wav_syn, wav_raw, sr)
    if len(a1) < 2:
        return float("nan")
    return float(np.corrcoef(a1, a2)[0, 1])


# -- FFE -------------------------------------------------------------------
def ffe(wav_ref: np.ndarray, wav_syn: np.ndarray, sr: int = SR) -> float:
    """F0 frame error = (gross pitch errors + voicing decision errors) /
    n_frames (metrics/f0_frame_error.py:36-57); inputs are silence-trimmed
    and zero-padded to equal length (all_metrics.py:534-559)."""
    wav_ref = trim_silence(wav_ref)
    wav_syn = trim_silence(wav_syn)
    L = max(len(wav_ref), len(wav_syn))
    wav_ref = np.pad(wav_ref, (0, L - len(wav_ref)))
    wav_syn = np.pad(wav_syn, (0, L - len(wav_syn)))
    ref_f, _, _, _ = compute_yin(wav_ref, sr)
    syn_f, _, _, _ = compute_yin(wav_syn, sr)
    n = min(len(ref_f), len(syn_f))
    ref_f, syn_f = ref_f[:n], syn_f[:n]
    voiced = (ref_f != 0) & (syn_f != 0)
    gpe = voiced & (np.abs(syn_f / (ref_f + 1e-8) - 1) > 0.2)
    vde = (syn_f != 0) != (ref_f != 0)
    return float((gpe.sum() + vde.sum()) / max(n, 1))


# -- MCD -------------------------------------------------------------------
_LOG_SPEC_DB_CONST = 10.0 / math.log(10.0) * math.sqrt(2.0)


def _log_spec_db_dist(x: np.ndarray, y: np.ndarray) -> float:
    diff = x - y
    return _LOG_SPEC_DB_CONST * math.sqrt(np.inner(diff, diff))


def mcd24(wav_syn: np.ndarray, wav_raw: np.ndarray, sr: int = SR):
    """DTW accumulated-cost MCD over mcep[1:25]
    (all_metrics.py:389-447): returns (mean cost matrix, ref frames) —
    harness divides sum(mean)/sum(frames)."""
    c_syn = mcep(wav_syn, sr)
    c_raw = mcep(wav_raw, sr)
    D = dtw_cost(c_raw[:, 1:].T, c_syn[:, 1:].T, _log_spec_db_dist)
    return float(np.mean(D)), len(c_raw)


def mcd_dtw(wav_syn: np.ndarray, wav_raw: np.ndarray, sr: int = SR) -> float:
    """pymcd 'dtw'-mode MCD (all_metrics.py:447-454): mean frame-wise
    log-spectral distance along the optimal DTW path."""
    c_syn = mcep(wav_syn, sr)[:, 1:]
    c_raw = mcep(wav_raw, sr)[:, 1:]
    path = dtw_path(c_raw, c_syn)
    d = [_log_spec_db_dist(c_raw[i], c_syn[j]) for i, j in path]
    return float(np.mean(d))


def mcd_dctmel(wav_syn: np.ndarray, wav_raw: np.ndarray, sr: int = SR) -> float:
    """Internal regression MCD over the DCT-of-log-mel cepstrum (the
    round-1 substitute, kept under its own name; NOT comparable to the
    paper's MCD — use mcd/mcd24)."""
    c_syn = mcep_dctmel(wav_syn, sr)[:, 1:]
    c_raw = mcep_dctmel(wav_raw, sr)[:, 1:]
    path = dtw_path(c_raw, c_syn)
    d = [_log_spec_db_dist(c_raw[i], c_syn[j]) for i, j in path]
    return float(np.mean(d))


def log_f0_mcep(wav_syn: np.ndarray, wav_raw: np.ndarray, sr: int = SR) -> float:
    """The reference's 'log_f0' — actually a DTW distance over mceps with
    a 1/min_len-scaled L2 metric (all_metrics.py:335-350)."""
    c1 = mcep(wav_syn, sr)
    c2 = mcep(wav_raw, sr)
    const = 1.0 / min(len(c1), len(c2))

    def metric(x, y):
        diff = x - y
        return const * math.sqrt(np.inner(diff, diff))

    D = dtw_cost(c1[:, 1:].T, c2[:, 1:].T, metric)
    return float(np.mean(D))


# -- SSIM ------------------------------------------------------------------
def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    return np.outer(g, g)


def ssim_2d(img1: np.ndarray, img2: np.ndarray, data_range: float) -> float:
    """SSIM with 11x11 sigma-1.5 gaussian window (torchmetrics
    StructuralSimilarityIndexMeasure defaults, all_metrics.py:352-388)."""
    from scipy.signal import fftconvolve

    w = _gaussian_window()
    K1, K2 = 0.01, 0.03
    C1, C2 = (K1 * data_range) ** 2, (K2 * data_range) ** 2
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)

    def filt(x):
        return fftconvolve(x, w, mode="valid")

    mu1, mu2 = filt(img1), filt(img2)
    mu1_sq, mu2_sq, mu12 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    s1 = filt(img1 * img1) - mu1_sq
    s2 = filt(img2 * img2) - mu2_sq
    s12 = filt(img1 * img2) - mu12
    ssim_map = ((2 * mu12 + C1) * (2 * s12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (s1 + s2 + C2))
    return float(ssim_map.mean())


def aligned_norm_mfcc(wav1: np.ndarray, wav2: np.ndarray, sr: int = SR):
    """DTW-aligned column-normalized MFCC pair (all_metrics.py:358-380)."""
    m1 = mfcc(wav1, sr)
    m2 = mfcc(wav2, sr)
    path = dtw_path(m1.T, m2.T)
    a1, a2 = align_by_path(m1, m2, path)
    a1 = a1 / (np.linalg.norm(a1, axis=0, keepdims=True) + 1e-12)
    a2 = a2 / (np.linalg.norm(a2, axis=0, keepdims=True) + 1e-12)
    return a1, a2


def mfcc_cos(wav_syn: np.ndarray, wav_raw: np.ndarray, sr: int = SR) -> float:
    """Cosine similarity of flattened aligned MFCCs (all_metrics.py:603-620)."""
    a1, a2 = aligned_norm_mfcc(wav_syn, wav_raw, sr)
    v1, v2 = a1.reshape(-1), a2.reshape(-1)
    return float(v1 @ v2 / (np.linalg.norm(v1) * np.linalg.norm(v2) + 1e-12))


# -- SDR -------------------------------------------------------------------
def si_sdr(wav_syn: np.ndarray, wav_raw: np.ndarray) -> float:
    """Scale-invariant SDR on DTW-aligned waveforms (all_metrics.py:281-304)."""
    path = dtw_path(wav_syn[:, None], wav_raw[:, None])
    syn = wav_syn[[p[0] for p in path]].astype(np.float64)
    raw = wav_raw[[p[1] for p in path]].astype(np.float64)
    eps = np.finfo(float).eps
    alpha = (syn @ raw) / (syn @ syn + eps)
    num = ((alpha * raw) ** 2).sum()
    den = ((alpha * raw - syn) ** 2).sum()
    return float(10 * np.log10(num / (den + eps)))


def mel_sdr(mel_syn: np.ndarray, mel_raw: np.ndarray) -> float:
    """SDR over (T, n_mels) cached mels, truncated to common length
    (all_metrics.py:622-668)."""
    L = min(len(mel_syn), len(mel_raw))
    s = mel_syn[:L].reshape(-1).astype(np.float64)
    r = mel_raw[:L].reshape(-1).astype(np.float64)
    eps = np.finfo(float).eps
    return float(10 * np.log10((r ** 2).sum() / (((r - s) ** 2).sum() + eps)))


# -- GMM KL ----------------------------------------------------------------
def gmm_kl(feat_target: np.ndarray, feat_pred: np.ndarray,
           n_components: int = 30, seed: int = 0) -> float:
    """KL between GMMs fit on target/predicted frame features
    (all_metrics.py:110-127).  NOTE: the reference fits BOTH GMMs on
    ``pair[0]`` (a bug — its KL is identically ~0); implemented correctly
    here."""
    from scipy.stats import entropy
    try:
        from sklearn.mixture import GaussianMixture
    except ImportError as e:
        raise ImportError("gmm_kl needs scikit-learn (GaussianMixture), "
                          "which is not installed") from e

    n = min(n_components, len(feat_target) // 2, len(feat_pred) // 2)
    n = max(n, 1)
    g_t = GaussianMixture(n_components=n, covariance_type="full",
                          random_state=seed).fit(feat_target)
    g_p = GaussianMixture(n_components=n, covariance_type="full",
                          random_state=seed).fit(feat_pred)
    kl = entropy(np.exp(g_t.score_samples(feat_target)),
                 np.exp(g_p.score_samples(feat_target)))
    return 0.0 if not np.isfinite(kl) else float(kl)


# -- WER -------------------------------------------------------------------
def edit_distance(ref: list, hyp: list) -> int:
    n, m = len(ref), len(hyp)
    d = np.arange(m + 1)
    for i in range(1, n + 1):
        prev = d.copy()
        d[0] = i
        for j in range(1, m + 1):
            d[j] = min(prev[j] + 1, d[j - 1] + 1,
                       prev[j - 1] + (ref[i - 1] != hyp[j - 1]))
    return int(d[m])


def _norm_words(s: str, strip_punct: bool = True) -> list[str]:
    import re

    s = s.lower()
    if strip_punct:
        s = re.sub(r"[^\w\s']", " ", s)
    return s.split()


def wer_counts(ref_text: str, hyp_text: str,
               strip_punct: bool = True) -> tuple[int, int]:
    """(word edit distance, reference word count) for one utterance —
    the corpus-level WER is sum(edits)/sum(ref words), which is what
    ``jiwer.wer(list, list)`` computes in the reference
    (all_metrics.py:275-280)."""
    ref = _norm_words(ref_text, strip_punct)
    hyp = _norm_words(hyp_text, strip_punct)
    return edit_distance(ref, hyp), len(ref)


def wer(ref_text: str, hyp_text: str, strip_punct: bool = True) -> float:
    """Word error rate of one utterance pair (jiwer replacement,
    all_metrics.py:228-283; both sides lowercased + punctuation
    stripped, slightly stricter than the reference which lowercases
    only the hypothesis)."""
    edits, n_ref = wer_counts(ref_text, hyp_text, strip_punct)
    if n_ref == 0:
        return 0.0 if edits == 0 else 1.0
    return edits / n_ref


def make_transcriber(spec):
    """Pluggable transcriber factory for the WER path.

    - callable -> returned as-is (``transcribe(wav, sr) -> str``);
    - str      -> a transformers ASR pipeline from a LOCAL directory of
      whisper weights (a hub id is refused: nothing is downloaded);
      raises with the underlying error instead of silently degrading;
    - None     -> None (``wer`` then raises, asking for one).
    """
    if spec is None or callable(spec):
        return spec
    if not isinstance(spec, str):
        raise TypeError(f"transcriber spec must be callable|str|None, "
                        f"got {type(spec)}")
    if not os.path.isdir(spec):
        raise FileNotFoundError(
            f"transcriber {spec!r} is not a local directory of whisper "
            "weights (models are not downloaded)")
    try:
        from transformers import pipeline
    except ImportError as e:
        raise ImportError("a whisper transcriber needs the transformers "
                          "package, which is not installed") from e

    asr = pipeline("automatic-speech-recognition", model=spec)
    return lambda wav, sr: asr({"raw": np.asarray(wav, np.float32),
                                "sampling_rate": sr})["text"]


# -- FID & manifold precision/recall ----------------------------------------
def frechet_distance(feat1: np.ndarray, feat2: np.ndarray) -> float:
    """Gaussian Fréchet distance over frame-feature sets
    (metrics/fid.py:13-100 semantics)."""
    from scipy import linalg

    mu1, mu2 = feat1.mean(0), feat2.mean(0)
    s1 = np.cov(feat1, rowvar=False)
    s2 = np.cov(feat2, rowvar=False)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(s1 @ s2)
    if isinstance(covmean, tuple):
        covmean = covmean[0]
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(s1) + np.trace(s2) - 2 * np.trace(covmean))


def manifold_precision_recall(gen_feats: np.ndarray, ref_feats: np.ndarray,
                              k: int = 3) -> tuple[float, float]:
    """Improved precision/recall (Kynkäänniemi et al.): a sample counts
    if it lies inside any kNN-ball of the other set
    (metrics/fid.py k-NN manifold estimation)."""
    def knn_radii(x):
        d = np.sqrt(np.maximum(
            (x ** 2).sum(1)[:, None] + (x ** 2).sum(1)[None, :] - 2 * x @ x.T,
            0.0))
        np.fill_diagonal(d, np.inf)
        return np.sort(d, axis=1)[:, k - 1]

    def coverage(samples, manifold, radii):
        d = np.sqrt(np.maximum(
            (samples ** 2).sum(1)[:, None] + (manifold ** 2).sum(1)[None, :]
            - 2 * samples @ manifold.T, 0.0))
        return float((d <= radii[None, :]).any(axis=1).mean())

    r_ref = knn_radii(ref_feats)
    r_gen = knn_radii(gen_feats)
    precision = coverage(gen_feats, ref_feats, r_ref)
    recall = coverage(ref_feats, gen_feats, r_gen)
    return precision, recall


def frame_features(paths: list[str], feature_type: str, sr: int = SR,
                   max_frames_per_file: int = 400,
                   seed: int = 0) -> np.ndarray:
    """Stack per-frame features over a file list (metrics/fid.py caching
    layer, minus the cache)."""
    rng = np.random.RandomState(seed)
    feats = []
    for p in paths:
        wav = load_wav(p, sr)
        if feature_type == "mel":
            f = mel_power(wav, sr).T
        elif feature_type in ("mfcc", "mfcc_un_norm"):
            f = mfcc(wav, sr).T
            if feature_type == "mfcc":
                f = f / (np.linalg.norm(f, axis=0, keepdims=True) + 1e-12)
        else:
            raise ValueError(feature_type)
        if len(f) > max_frames_per_file:
            f = f[rng.choice(len(f), max_frames_per_file, replace=False)]
        feats.append(f)
    return np.concatenate(feats, axis=0)


# -- speaker cos -------------------------------------------------------------
def speaker_cos(wav_syn: np.ndarray, wav_raw: np.ndarray,
                embedder=None, device=None) -> float:
    """Cosine similarity of speaker embeddings.  Reference uses
    Resemblyzer VoiceEncoder (all_metrics.py:561-601), absent here; the
    GE2E encoder (same architecture family) stands in — pass a custom
    ``embedder(wav) -> vec`` to override.  Without one, a GE2E with random
    weights (torch seed 0) embeds on ``device`` (``cuda`` by default)."""
    if embedder is None:
        from cmtts_tpu_torch.models.speaker import (
            GE2EInference, ge2e_from_checkpoint)

        embedder = GE2EInference(ge2e_from_checkpoint(None),
                                 device).embed_utterance
    e1 = np.asarray(embedder(wav_syn)).reshape(-1)
    e2 = np.asarray(embedder(wav_raw)).reshape(-1)
    return float(e1 @ e2 / (np.linalg.norm(e1) * np.linalg.norm(e2) + 1e-12))
