"""Evaluation metrics on the device: motion FID, SiFID, diversity, sampling rate.

Counterpart of ``deepmimic_diffusion_mujoco_tpu/eval/metrics.py``:

- "activations" are the raw flattened trajectories (no learned feature
  extractor); mu and Sigma use the (n-1) covariance normaliser;
- the Frechet distance takes the matrix square root of Sigma1 @ Sigma2 by
  SVD, with singular values clamped at 1e-6: the same approximation the
  JAX package (and the reference it follows) accepts, kept for parity. It
  equals the true square root only up to the product's non-normality;
- sliding-window slicing, inter-diversity (half-batch L2), intra-diversity
  (random window pairs from an explicit ``torch.Generator``) and SiFID
  (per-sample FID of window slices against the ground truth's, batched
  over samples).

Statistics run where the samples lie, in float32; only scalars move to the
host.
"""
from __future__ import annotations

import time

import numpy as np
import torch


def slice_windows(sample: torch.Tensor, window_size: int, step_size: int = 10) -> torch.Tensor:
    """(..., T, D) -> (..., num_windows, window_size, D): windows at offsets
    0, step, 2·step, ... that fit in T."""
    T = sample.shape[-2]
    offsets = np.arange(T - window_size + 1)[::step_size]
    idx = torch.from_numpy(offsets[:, None] + np.arange(window_size)[None, :])
    return sample[..., idx.to(sample.device), :]


def _statistics(feats: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """mu (..., F) and Sigma (..., F, F) of feature rows (..., N, F)."""
    feats = feats.to(torch.float32)
    mu = feats.mean(dim=-2)
    centered = feats - mu[..., None, :]
    return mu, centered.transpose(-1, -2) @ centered / (feats.shape[-2] - 1)


def activation_statistics(data: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """mu (F,) and Sigma (F, F) of N flattened trajectories (N, ...)."""
    return _statistics(data.reshape(data.shape[0], -1))


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> torch.Tensor:
    """Frechet distance with the SVD square root of Sigma1 @ Sigma2
    (batched over leading axes)."""
    diff = mu1 - mu2
    diff_sq = (diff * diff).sum(dim=-1)
    product = sigma1 @ sigma2
    # torch's SVD refuses non-finite input; such a product's distance is NaN, as in JAX
    finite = torch.isfinite(product).flatten(-2).all(dim=-1)
    # on the card cuSOLVER's gesvd: at SiFID's (2, 690, 690) faster than the default
    # driver on an NVIDIA H100 (chip_smoke.py's b_eval phase times both)
    u, s, vh = torch.linalg.svd(torch.where(finite[..., None, None], product, 0.0),
                                driver="gesvd" if product.is_cuda else None)
    covmean = (u * torch.sqrt(s.clamp(min=eps))[..., None, :]) @ vh
    trace = lambda m: m.diagonal(dim1=-2, dim2=-1).sum(dim=-1)  # noqa: E731
    fd = diff_sq + trace(sigma1) + trace(sigma2) - 2 * trace(covmean)
    return torch.where(finite, fd, torch.nan)


def motion_fid(real: torch.Tensor, generated: torch.Tensor) -> float:
    """FID between two trajectory batches (B, H, D)."""
    mu1, s1 = activation_statistics(real)
    mu2, s2 = activation_statistics(generated)
    return float(frechet_distance(mu1, s1, mu2, s2))


def inter_diversity(samples: torch.Tensor) -> float:
    """Mean L2 between the first and second half of the batch; an odd batch
    drops its middle element."""
    n = samples.shape[0] // 2
    emb = samples.reshape(samples.shape[0], -1)
    second = emb[-n:] if samples.shape[0] % 2 else emb[n:]
    return float(torch.linalg.norm(emb[:n] - second, dim=1).mean())


def window_pair_distance(samples: torch.Tensor, offsets: torch.Tensor,
                         window_size: int = 10) -> float:
    """Mean L2 between the two windows of each sample (B, T, D) that start
    at ``offsets`` (B, 2)."""
    win = torch.arange(window_size, device=samples.device)
    b = torch.arange(samples.shape[0], device=samples.device)[:, None]
    w0 = samples[b, offsets[:, :1] + win]
    w1 = samples[b, offsets[:, 1:] + win]
    return float(torch.linalg.norm((w0 - w1).flatten(1), dim=1).mean())


def intra_diversity(samples: torch.Tensor, generator: torch.Generator,
                    window_size: int = 10) -> float:
    """Mean L2 between two random windows of each sample (window starts
    drawn from ``generator``, uniform in [0, T - window_size))."""
    B, T, _ = samples.shape
    offsets = torch.randint(0, T - window_size, (B, 2), generator=generator,
                            device=generator.device)
    return window_pair_distance(samples, offsets.to(samples.device), window_size)


def sifid(generated: torch.Tensor, gt_sample: torch.Tensor, window_size: int = 10,
          step_size: int = 10, gt_step_size: int | None = None) -> float:
    """Single-instance FID: per generated sample (B, T, D), the FID of its
    window slices against the ground-truth clip's (T', D) slices; the mean
    over the batch. ``gt_step_size`` (default ``step_size``) strides the
    ground-truth side on its own: 1 gives a densely windowed reference,
    which short clips need for a covariance of full rank."""
    gt_slices = slice_windows(gt_sample, window_size,
                              step_size if gt_step_size is None else gt_step_size)
    gt_mu, gt_sigma = activation_statistics(gt_slices)
    # every sample's window slices at once: (B, windows, window_size * D)
    mu, sigma = _statistics(slice_windows(generated, window_size, step_size).flatten(-2))
    return float(frechet_distance(gt_mu, gt_sigma, mu, sigma).mean())


def timed_sampling_rate(sample_fn, num_samples: int) -> tuple[torch.Tensor, float]:
    """-> (samples, samples per second), the clock stopped after the device
    has finished the samples."""
    t0 = time.perf_counter()
    samples = sample_fn(num_samples)
    if samples.is_cuda:
        torch.cuda.synchronize(samples.device)
    return samples, num_samples / (time.perf_counter() - t0)


def evaluate(sample_fn, gt_sample: torch.Tensor, num_samples: int = 50,
             replications: int = 5, window_size: int = 10, seed: int = 0) -> dict:
    """Per replication: draw samples, then sampling rate, inter- and
    intra-diversity (the ground truth's beside it, from the same window
    draw seed) and SiFID; -> {metric: {"mean", "std"}} over replications."""
    rows = []
    for rep in range(replications):
        samples, rate = timed_sampling_rate(sample_fn, num_samples)

        def gen():
            return torch.Generator(device=gt_sample.device).manual_seed(seed + rep)

        gt_intra = intra_diversity(gt_sample.expand((2,) + gt_sample.shape), gen(), window_size)
        intra = intra_diversity(samples, gen(), window_size)
        rows.append({
            "sampling_rate": rate,
            "inter_diversity": inter_diversity(samples),
            "intra_diversity": intra,
            "gt_intra_diversity": gt_intra,
            "intra_diversity_gt_diff": abs(intra - gt_intra),
            "sifid": sifid(samples, gt_sample, window_size),
        })
    out = {}
    for key in rows[0]:
        vals = np.array([r[key] for r in rows])
        out[key] = {"mean": float(vals.mean()), "std": float(vals.std())}
    return out
