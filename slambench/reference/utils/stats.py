"""Masked robust statistics (counterpart of nrslam_tpu/utils/stats.py)."""

from __future__ import annotations

import torch

# Chi-squared 95% critical values, 1..10 degrees of freedom
# (statistics_toolbox.cc:52-90), on the CPU: ``.to(device)`` where needed.
CHI2_95 = torch.tensor([3.841, 5.991, 7.815, 9.488, 11.070, 12.592, 14.067,
                        15.507, 16.919, 18.307], dtype=torch.float32)


def masked_mean(x, mask, dim=None):
    m = mask.to(x.dtype)
    if dim is None:
        return torch.sum(x * m) / torch.clamp(torch.sum(m), min=1.0)
    return torch.sum(x * m, dim=dim) / torch.clamp(torch.sum(m, dim=dim),
                                                   min=1.0)


def masked_sigma(x, mask, dim=None):
    mu = masked_mean(x, mask, dim=dim)
    if dim is not None:
        mu = mu.unsqueeze(dim)
    var = masked_mean((x - mu) ** 2, mask, dim=dim)
    return torch.sqrt(var)


def masked_quantile_sorted(x, mask, frac: float):
    """Value at index floor(frac * n_valid) of the sorted valid entries
    (index lookup, the reference's quartile convention)."""
    big = torch.full_like(x, float("inf"))
    xs = torch.sort(torch.where(mask, x, big), dim=-1).values
    n_valid = torch.sum(mask.to(torch.int32), dim=-1)
    idx = (n_valid.to(torch.float32) * frac).to(torch.int64)
    idx = torch.minimum(torch.clamp(idx, min=0),
                        torch.clamp(n_valid.to(torch.int64) - 1, min=0))
    return torch.gather(xs, -1, idx.unsqueeze(-1)).squeeze(-1)


def masked_median(x, mask):
    """nth_element(n/2) median (index n//2 of the sorted valid entries)."""
    return masked_quantile_sorted(x, mask, 0.5)


def iqr_upper_threshold(x, mask):
    """q3 + 1.5*IQR outlier threshold over the valid entries."""
    q1 = masked_quantile_sorted(x, mask, 0.25)
    q3 = masked_quantile_sorted(x, mask, 0.75)
    return q3 + 1.5 * (q3 - q1)
