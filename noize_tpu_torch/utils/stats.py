"""Small statistics helpers — port of ``noize_tpu.utils.stats``
(``Regression`` parity, Regression.cs:8-48): mean, sum of squared
differences, SXY, MSE, the log-model prediction and its least-squares
fit, on float tensors."""

from __future__ import annotations

import torch


def mean(items):
    return torch.mean(items)


def sum_square_difference(items):
    m = torch.mean(items)
    return torch.sum((items - m) ** 2)


def compute_sxy(xs, ys):
    return torch.sum((xs - torch.mean(xs)) * (ys - torch.mean(ys)))


def mean_square_error(pred, real):
    return torch.mean((pred - real) ** 2)


def predict_log(x, b1, b2):
    return b1 + b2 * torch.log(torch.as_tensor(x))


def fit_log(xs, ys):
    """Least-squares fit of y = b1 + b2·log(x) (the LogRegression the
    reference sketched but left commented — Regression.cs:49+)."""
    lx = torch.log(xs)
    b2 = compute_sxy(lx, ys) / sum_square_difference(lx)
    b1 = torch.mean(ys) - b2 * torch.mean(lx)
    return b1, b2
