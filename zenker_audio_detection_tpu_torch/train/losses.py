"""Loss functions of the two training stages, on torch tensors.

The port of the JAX package's `train/losses.py`, which replicates the
reference's two custom Trainer subclasses:

Stage 1 (`FocalLossTrainer`):
  γ>0:   FL = mean((1 - exp(-ce))^γ * ce) with ce the torch-style
         label-smoothed cross-entropy (smoothing mass ls/C on ALL classes).
  γ==0:  plain label-smoothed CE.

Stage 2 (`ImprovedWeightedTrainer`): focal loss with a different smoothing
scheme (ls/(C-1) on the non-true classes only), per-sample class weights and
the batch-level α quirk (α_t = α if mean(labels) < 0.5 else 1-α), kept
exactly because it produced the paper's baseline numbers.

Logits are taken to f32 before the log-softmax, whatever their dtype. The
`*_traced` variants of the JAX module belong to the trial-parallel sweep and
are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch


def _log_softmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(logits.float(), dim=-1)


def _pick(x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """x[i, labels[i]] for every row i."""
    return x.gather(-1, labels.long()[:, None])[:, 0]


def torch_smoothed_ce(logits, labels, label_smoothing: float = 0.0):
    """Per-sample CE matching `torch.nn.functional.cross_entropy(...,
    label_smoothing=ls, reduction="none")`: the target puts (1 - ls) + ls/C
    on the true class and ls/C elsewhere."""
    logp = _log_softmax(logits)
    nll = -_pick(logp, labels)
    if label_smoothing == 0.0:
        return nll
    smooth = -logp.mean(dim=-1)
    return (1.0 - label_smoothing) * nll + label_smoothing * smooth


def _masked_mean(per_sample, mask):
    mask = torch.as_tensor(mask, dtype=per_sample.dtype,
                           device=per_sample.device)
    return (per_sample * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def stage1_loss(logits, labels, focal_gamma: float = 0.0,
                label_smoothing: float = 0.0, sample_mask=None):
    """FocalLossTrainer.compute_loss, mean-reduced scalar.

    sample_mask (0/1 per row): the mean over the valid rows only, identical
    to the plain mean on just those rows."""
    ce = torch_smoothed_ce(logits, labels, label_smoothing)
    per = (1.0 - torch.exp(-ce)) ** focal_gamma * ce if focal_gamma > 0 else ce
    if sample_mask is None:
        return per.mean()
    return _masked_mean(per, sample_mask)


def stage2_focal_loss(logits, labels, class_weights=None,
                      focal_alpha: float | None = 0.25,
                      focal_gamma: float = 2.0,
                      label_smoothing: float = 0.1, sample_mask=None):
    """ImprovedWeightedTrainer.focal_loss_with_smoothing.

    sample_mask: masked mean as in stage1_loss; the batch-level α uses the
    masked label mean, so padded rows cannot flip it."""
    logp = _log_softmax(logits)
    probs = torch.exp(logp)
    C = logits.shape[-1]

    # smoothing mass ls/(C-1) on the non-true classes, 1-ls on the true one
    onehot = torch.nn.functional.one_hot(labels.long(), C).to(logp.dtype)
    smooth = (torch.full_like(logp, label_smoothing / (C - 1)) * (1.0 - onehot)
              + (1.0 - label_smoothing) * onehot)

    p_t = _pick(probs, labels)
    focal_weight = (1.0 - p_t) ** focal_gamma
    ce = -(smooth * logp).sum(dim=-1)
    loss = focal_weight * ce

    if class_weights is not None:
        w = torch.as_tensor(np.asarray(class_weights, np.float32),
                            device=loss.device)
        loss = loss * w[labels.long()]

    if focal_alpha is not None:
        labf = labels.float()
        lab_mean = (labf.mean() if sample_mask is None
                    else _masked_mean(labf, sample_mask))
        loss = loss * torch.where(lab_mean < 0.5, focal_alpha,
                                  1.0 - focal_alpha)
    if sample_mask is None:
        return loss.mean()
    return _masked_mean(loss, sample_mask)


def stage2_weighted_ce(logits, labels, class_weights=None,
                       label_smoothing: float = 0.1, sample_mask=None):
    """The `--no-focal-loss` path: torch CrossEntropyLoss(weight=w,
    label_smoothing=ls) semantics: per-sample = (1-ls)·w[y]·nll +
    ls·(-Σ_c w_c·logp_c)/C, the mean normalized by Σ w[y]. sample_mask:
    both sums run over the valid rows only."""
    logp = _log_softmax(logits)
    C = logits.shape[-1]
    nll = -_pick(logp, labels)
    if class_weights is None:
        smooth = -logp.mean(dim=-1)
        per = (1.0 - label_smoothing) * nll + label_smoothing * smooth
        if sample_mask is None:
            return per.mean()
        return _masked_mean(per, sample_mask)
    w = torch.as_tensor(np.asarray(class_weights, np.float32),
                        device=logp.device)
    wi = w[labels.long()]
    smooth = -(logp * w[None, :]).sum(dim=-1) / C
    num = (1.0 - label_smoothing) * wi * nll + label_smoothing * smooth
    if sample_mask is None:
        return num.sum() / wi.sum()
    mask = torch.as_tensor(sample_mask, dtype=num.dtype, device=num.device)
    return (num * mask).sum() / torch.clamp((wi * mask).sum(), min=1e-9)


def inverse_frequency_weights(labels, num_classes: int = 2) -> np.ndarray:
    """Class weights from the train labels: n_total / (n_classes *
    count_c), f32."""
    labels = np.asarray(labels)
    counts = np.bincount(labels, minlength=num_classes).astype(np.float64)
    return (len(labels) / (num_classes * np.maximum(counts, 1))).astype(
        np.float32)


def hf_eval_loss(loss_fn, logits, labels, batch_size: int) -> float:
    """HF Trainer eval-loss reduction: the mean loss of each eval batch,
    combined as a sample-weighted mean (the trailing batch is partial,
    never padded). The batching matters for the stage-2 focal loss, whose
    batch-level α makes the value depend on how samples are grouped.
    `logits` and `labels` may be numpy arrays or tensors."""
    logits = torch.as_tensor(np.asarray(logits))
    labels = torch.as_tensor(np.asarray(labels))
    n = len(labels)
    if n == 0:
        return float("nan")
    total = 0.0
    for s in range(0, n, int(batch_size)):
        yb = labels[s: s + int(batch_size)]
        total += float(loss_fn(logits[s: s + int(batch_size)], yb)) * len(yb)
    return total / n
