"""P-FID / P-IS statistics (numpy and scipy, on the host).

The port's own copy of :mod:`pcdiff.evals.fid_is`: the Frechet distance between two
Gaussian feature statistics through a matrix square root, retaken with ``eps`` on the
diagonals when the product is near singular, and the improved-GAN inception score over
splits of the class probabilities (a class probability of exactly 0 adds 0, the KL
limit).
"""

from __future__ import annotations

import warnings

import numpy as np
from scipy import linalg

__all__ = [
    "InvalidFIDException",
    "FIDStatistics",
    "compute_statistics",
    "compute_inception_score",
]


class InvalidFIDException(Exception):
    pass


class FIDStatistics:
    def __init__(self, mu: np.ndarray, sigma: np.ndarray):
        self.mu = mu
        self.sigma = sigma

    def frechet_distance(self, other: "FIDStatistics", eps: float = 1e-6) -> float:
        """||mu1-mu2||^2 + Tr(S1 + S2 - 2 sqrt(S1 S2))."""
        mu1, sigma1 = np.atleast_1d(self.mu), np.atleast_2d(self.sigma)
        mu2, sigma2 = np.atleast_1d(other.mu), np.atleast_2d(other.sigma)
        assert mu1.shape == mu2.shape and sigma1.shape == sigma2.shape

        diff = mu1 - mu2
        # the same square root as the JAX package's sqrtm(..., disp=False)[0]; newer
        # SciPy has no disp argument
        covmean = linalg.sqrtm(sigma1.dot(sigma2))
        if not np.isfinite(covmean).all():
            warnings.warn(
                f"fid calculation produces singular product; adding {eps} to the "
                "diagonal of cov estimates"
            )
            offset = np.eye(sigma1.shape[0]) * eps
            covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
        if np.iscomplexobj(covmean):
            if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
                raise ValueError(
                    f"Imaginary component {np.max(np.abs(covmean.imag))}"
                )
            covmean = covmean.real
        return float(
            diff.dot(diff)
            + np.trace(sigma1)
            + np.trace(sigma2)
            - 2 * np.trace(covmean)
        )


def compute_statistics(feats: np.ndarray) -> FIDStatistics:
    return FIDStatistics(np.mean(feats, axis=0), np.cov(feats, rowvar=False))


def compute_inception_score(preds: np.ndarray, split_size: int = 5000) -> float:
    """exp(mean KL(p(y|x) || p(y))) averaged over splits."""
    scores = []
    for i in range(0, len(preds), split_size):
        part = preds[i : i + split_size]
        # 0 * log(0) -> 0, the KL limit, where a class probability underflows to 0
        with np.errstate(divide="ignore", invalid="ignore"):
            kl = part * (
                np.log(part) - np.log(np.mean(part, axis=0, keepdims=True))
            )
        kl = np.where(part > 0, kl, 0.0)
        scores.append(np.exp(np.mean(np.sum(kl, axis=1))))
    return float(np.mean(scores))
