"""Generalized linear models (LR / SVM) — losses, gradients, execution paths.

Binary classification with logistic regression

    f_LR(w)  = log(1 + exp(-y * x.w))
    dLR/dw_j = x_j * (-y * sigma(-y * x.w))        [sigma = logistic]

and linear SVM (hinge loss)

    f_SVM(w) = max(0, 1 - y * x.w)
    dSVM/dw_j = -y * x_j   if  y * x.w < 1  else 0

Two tensor paths live here: ``grad_primitive_composition`` (the paper's
chain of blocking linear-algebra primitives, Section 4) and ``grad_fused``
(the whole pipeline as one expression).  The hand-written kernel is
``kernels/glm_grad``.

All paths take a batch ``X: [B, d]``, ``y: [B]`` (labels in {-1, +1}),
``w: [d]`` and return the *sum* gradient over the batch (Algorithm 2
accumulates sums; callers divide by B for the mean).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

Tensor = torch.Tensor

# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def _lr_sum(margins: Tensor) -> Tensor:
    # log(1 + e^-m) = max(-m, 0) + log1p(exp(-|m|))  (numerically stable)
    return torch.sum(torch.clamp(-margins, min=0.0)
                     + torch.log1p(torch.exp(-torch.abs(margins))))


def _svm_sum(margins: Tensor) -> Tensor:
    return torch.sum(torch.clamp(1.0 - margins, min=0.0))


def lr_loss(w: Tensor, X: Tensor, y: Tensor) -> Tensor:
    """Sum logistic loss over the batch."""
    return _lr_sum(y * (X @ w))


def svm_loss(w: Tensor, X: Tensor, y: Tensor) -> Tensor:
    """Sum hinge loss over the batch."""
    return _svm_sum(y * (X @ w))


LOSSES: dict[str, Callable[[Tensor, Tensor, Tensor], Tensor]] = {
    "lr": lr_loss,
    "svm": svm_loss,
}

#: sum loss of a margin vector, per task (shared with core.sparse)
MARGIN_LOSSES: dict[str, Callable[[Tensor], Tensor]] = {
    "lr": _lr_sum,
    "svm": _svm_sum,
}

# ---------------------------------------------------------------------------
# Per-example "pull" (the scalar that multiplies x_i in the gradient)
# ---------------------------------------------------------------------------
# grad = X^T @ pull(margins) with margins = y * (X @ w):
#   LR : pull = -y * sigmoid(-margin)
#   SVM: pull = -y * (margin < 1)


def lr_pull(margins: Tensor, y: Tensor) -> Tensor:
    return -y * torch.sigmoid(-margins)


def svm_pull(margins: Tensor, y: Tensor) -> Tensor:
    return -y * (margins < 1.0).to(margins.dtype)


PULLS: dict[str, Callable[[Tensor, Tensor], Tensor]] = {
    "lr": lr_pull,
    "svm": svm_pull,
}

# ---------------------------------------------------------------------------
# Inference links (margin -> served score): LR a probability, SVM the raw
# decision value.
# ---------------------------------------------------------------------------


def lr_link(margins: Tensor) -> Tensor:
    return torch.sigmoid(margins)


def svm_link(margins: Tensor) -> Tensor:
    return margins


LINKS: dict[str, Callable[[Tensor], Tensor]] = {
    "lr": lr_link,
    "svm": svm_link,
}


# ---------------------------------------------------------------------------
# Execution path 1: primitive composition (ViennaCL / TF / BIDMach analogue)
# ---------------------------------------------------------------------------


def grad_primitive_composition(task: str, w: Tensor, X: Tensor, y: Tensor) -> Tensor:
    """Paper Section 4 function sequence, one launch per primitive.

    Eager PyTorch runs every line as its own kernel and materialises its
    result, which is the blocking-primitive boundary the paper measures:
    nothing fuses across lines.  For LR the sequence is the paper's:
        a = matrix-vector-product(data, model)
        a = vector-vector-element-product(label, a)
        a = vector-element-exponent(-a)
        b = vector-element-sum(1, a)
        a = vector-vector-element-division(a, b)
        a = vector-vector-element-product(a, -label)
        g = matrix-vector-product(transpose(data), a)
    """
    if task == "lr":
        a = X @ w
        a = y * a
        a = torch.exp(-a)
        b = 1.0 + a
        a = a / b
        a = a * (-y)
        return X.T @ a
    if task == "svm":
        a = X @ w
        a = y * a
        mask = (a < 1.0).to(X.dtype)
        a = mask * (-y)
        return X.T @ a
    raise ValueError(f"unknown task {task!r}")


# ---------------------------------------------------------------------------
# Execution path 2: fused expression
# ---------------------------------------------------------------------------


def grad_fused(task: str, w: Tensor, X: Tensor, y: Tensor) -> Tensor:
    margins = y * (X @ w)
    return X.T @ PULLS[task](margins, y)


def loss_and_grad(task: str, w: Tensor, X: Tensor, y: Tensor) -> tuple[Tensor, Tensor]:
    """Sum loss and sum gradient in one pass (shares the X @ w matvec)."""
    margins = y * (X @ w)
    return MARGIN_LOSSES[task](margins), X.T @ PULLS[task](margins, y)


# ---------------------------------------------------------------------------
# Sequential epochs
# ---------------------------------------------------------------------------


def incremental_epoch(task: str, w: Tensor, X: Tensor, y: Tensor, step: float) -> Tensor:
    """Paper Algorithm 3: for each example, gradient estimate then update.

    The sequential semantics Hogwild approximates, as a Python loop.
    """
    pull_fn = PULLS[task]
    for x_i, y_i in zip(X, y):
        pull = pull_fn(y_i * torch.dot(x_i, w), y_i)
        w = w - step * pull * x_i
    return w


def minibatch_epoch(
    task: str, w: Tensor, X: Tensor, y: Tensor, step: float, batch: int
) -> Tensor:
    """Mini-batch SGD epoch: model updated every ``batch`` examples.

    ``N`` must be divisible by ``batch``.
    """
    n = X.shape[0]
    if n % batch:
        raise ValueError(f"minibatch_epoch needs n % batch == 0, got {n}, {batch}")
    for s in range(0, n, batch):
        g = grad_fused(task, w, X[s:s + batch], y[s:s + batch])
        w = w - (step / batch) * g
    return w


# ---------------------------------------------------------------------------
# Problem container
# ---------------------------------------------------------------------------


class GLMProblem(NamedTuple):
    """A training problem instance: task + data + hyper-parameters."""

    task: str            # "lr" | "svm"
    X: Tensor            # [N, d]  (dense)  — sparse problems use core.sparse
    y: Tensor            # [N]     in {-1, +1}
    step: float          # SGD step size alpha


def full_loss(problem: GLMProblem, w: Tensor) -> Tensor:
    return LOSSES[problem.task](w, problem.X, problem.y)


def batch_gd_epoch(task: str, w: Tensor, X: Tensor, y: Tensor, step: float) -> Tensor:
    """Paper Algorithm 2 (batch SGD = full gradient, one update per epoch)."""
    return w - step * grad_fused(task, w, X, y)
