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
`*_traced` variants take focal_gamma and label_smoothing as tensors (0-d,
or one per trial under `torch.func.vmap`) and have no Python branch on
them: the trial-parallel sweep (train/trial_parallel.py) vmaps them over
trials. Class weights may be a tensor wherever they are taken (one per
fold in the fold-parallel trainer).
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


def _class_weights(class_weights, device) -> torch.Tensor:
    """The weights as an f32 tensor on `device`; a tensor passes as it is
    (it may be batched under vmap)."""
    if isinstance(class_weights, torch.Tensor):
        return class_weights.float()
    return torch.as_tensor(np.asarray(class_weights, np.float32),
                           device=device)


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
        loss = loss * _pick_weights(class_weights, labels, loss.device)

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
    w = _class_weights(class_weights, logp.device)
    wi = _pick_weights(w, labels, logp.device)
    smooth = -(logp * w[None, :]).sum(dim=-1) / C
    num = (1.0 - label_smoothing) * wi * nll + label_smoothing * smooth
    if sample_mask is None:
        return num.sum() / wi.sum()
    mask = torch.as_tensor(sample_mask, dtype=num.dtype, device=num.device)
    return (num * mask).sum() / torch.clamp((wi * mask).sum(), min=1e-9)


def _pick_weights(class_weights, labels, device) -> torch.Tensor:
    """w[labels[i]] for every row i (a gather, so that it also runs under
    vmap with per-fold weights)."""
    w = _class_weights(class_weights, device)
    return w.gather(0, labels.long())


def _safe_focal_base(x, gamma):
    """x**gamma with a clean gradient at gamma == 0 (where the sequential
    losses take the plain-CE branch): the where keeps x out of the power's
    gradient when the exponent is zero, which avoids 0**-1 at x == 0."""
    return torch.where(gamma > 0, x, 1.0) ** gamma


def _f32(x, device) -> torch.Tensor:
    """A traced hyperparameter as an f32 tensor (a tensor, possibly batched
    under vmap, passes as it is)."""
    if isinstance(x, torch.Tensor):
        return x.float()
    return torch.tensor(x, dtype=torch.float32, device=device)


def stage1_loss_traced(logits, labels, focal_gamma, label_smoothing,
                       sample_mask=None):
    """stage1_loss with focal_gamma / label_smoothing as tensors, without
    Python branches: equal to stage1_loss at every (γ, ls), including the
    branch points γ=0 (the focal factor is 1) and ls=0 (plain NLL)."""
    gamma = _f32(focal_gamma, logits.device)
    ls = _f32(label_smoothing, logits.device)
    logp = _log_softmax(logits)
    nll = -_pick(logp, labels)
    smooth = -logp.mean(dim=-1)
    ce = (1.0 - ls) * nll + ls * smooth
    per = _safe_focal_base(1.0 - torch.exp(-ce), gamma) * ce
    if sample_mask is None:
        return per.mean()
    return _masked_mean(per, sample_mask)


def stage2_focal_loss_traced(logits, labels, class_weights, focal_alpha,
                             focal_gamma, label_smoothing, sample_mask=None):
    """stage2_focal_loss with focal_gamma / label_smoothing as tensors
    (class_weights may be a tensor; focal_alpha stays a Python number: the
    reference's sweeps never touch it)."""
    gamma = _f32(focal_gamma, logits.device)
    ls = _f32(label_smoothing, logits.device)
    logp = _log_softmax(logits)
    probs = torch.exp(logp)
    C = logits.shape[-1]
    smooth = torch.full_like(logp, 1.0) * (ls / (C - 1))
    onehot = torch.nn.functional.one_hot(labels.long(), C).to(logp.dtype)
    smooth = smooth * (1.0 - onehot) + (1.0 - ls) * onehot
    p_t = _pick(probs, labels)
    loss = _safe_focal_base(1.0 - p_t, gamma) * (-(smooth * logp).sum(dim=-1))
    if class_weights is not None:
        loss = loss * _pick_weights(class_weights, labels, loss.device)
    if focal_alpha is not None:
        labf = labels.float()
        lab_mean = (labf.mean() if sample_mask is None
                    else _masked_mean(labf, sample_mask))
        loss = loss * torch.where(lab_mean < 0.5, focal_alpha,
                                  1.0 - focal_alpha)
    if sample_mask is None:
        return loss.mean()
    return _masked_mean(loss, sample_mask)


def stage2_weighted_ce_traced(logits, labels, class_weights, label_smoothing,
                              sample_mask=None):
    """stage2_weighted_ce with label_smoothing as a tensor (its formula is
    already branch-free; this keeps one traced API across the stages)."""
    return stage2_weighted_ce(logits, labels, class_weights,
                              _f32(label_smoothing, logits.device),
                              sample_mask=sample_mask)


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
