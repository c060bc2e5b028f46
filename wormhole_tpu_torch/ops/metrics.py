"""Binary-classification metrics on device (BinClassEval parity).

Reference learn/base/binary_class_evaluation.h: AUC (:17-38), accuracy
(:40-51), logloss (:53-64), logit objective (:66-74) and COPC (:76-85),
as torch reductions over masked fixed-shape batches. Labels are 0/1;
masked rows are excluded via weight 0.
"""

from __future__ import annotations

import torch


def softplus(x):
    """log(1 + e^x), exactly (no large-x threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def auc(y, score, mask):
    """Rank-based AUC: P(score_pos > score_neg). Ties get 0.5 credit via
    average ranks; masked rows go to -inf and are excluded from counts.

    Everything happens in the sorted domain: one sort carries the labels
    along, and tie groups are resolved with forward/backward running
    maxima over the sorted boundaries."""
    n = score.shape[0]
    s = torch.where(mask > 0, score, torch.full_like(score, -torch.inf))
    pos_f = ((y > 0.5) & (mask > 0)).to(torch.float32)
    sorted_s, order = torch.sort(s)
    pos_sorted = pos_f[order]
    idx = torch.arange(n, dtype=torch.float32, device=score.device)
    boundary = torch.ones(n, dtype=torch.bool, device=score.device)
    boundary[1:] = sorted_s[1:] != sorted_s[:-1]
    # group start = last boundary at or before i; group end = next
    # boundary after i, minus one
    start = torch.cummax(torch.where(boundary, idx, -1.0), 0).values
    rev_next = torch.cummax(
        torch.where(boundary, -idx, -torch.inf).flip(0), 0).values.flip(0)
    nxt = torch.cat([-rev_next[1:], idx.new_full((1,), torch.inf)])
    nxt = torch.clamp(nxt, max=float(n))
    avg_rank = (start + (nxt - 1.0)) * 0.5 + 1.0
    n_pos = torch.sum(pos_sorted)
    n_neg = torch.sum((mask > 0).to(torch.float32)) - n_pos
    # masked rows occupy ranks 1..n_masked; shift real ranks down
    n_masked = torch.sum((mask <= 0).to(torch.float32))
    rank_sum_pos = torch.sum(pos_sorted * (avg_rank - n_masked))
    u = rank_sum_pos - n_pos * (n_pos + 1) / 2
    ok = (n_pos > 0) & (n_neg > 0)
    return torch.where(ok, u / torch.where(ok, n_pos * n_neg, 1.0),
                       torch.full_like(u, 0.5))


def accuracy(y, score, mask, threshold: float = 0.0):
    """Fraction of rows with correct sign(score - threshold) prediction."""
    pred = score > threshold
    correct = (pred == (y > 0.5)).to(torch.float32) * mask
    return torch.sum(correct) / torch.clamp(torch.sum(mask), min=1.0)


def logloss(y, score, mask):
    """Mean negative log-likelihood of the logistic model; score is the
    margin (pre-sigmoid)."""
    ll = softplus(score) - y * score
    return torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def logit_objv(y, score, mask):
    """Sum logistic objective — the objv column of the progress row."""
    return torch.sum((softplus(score) - y * score) * mask)


def copc(y, score, mask):
    """Clicks over predicted clicks."""
    clicks = torch.sum(y * mask)
    pred = torch.sum(torch.sigmoid(score) * mask)
    return clicks / torch.clamp(pred, min=1e-12)
