"""Post-training probability calibration, folded into model parameters.

Port of the JAX package's ``training/calibrate.py``. Class-weighted training
shifts each branch's operating point (a pos_weight of ~16 inflates predicted
probabilities by roughly that factor in odds space), while the serving
combine averages raw probabilities, so an uncalibrated branch drags every
blend it joins. Platt scaling fits ``sigmoid(a * z + b)`` on held-out
logits, and because every neural branch ends in a plain affine head, (a, b)
folds into the existing parameters: the calibrated model is just a model and
the fused scorer (and the megakernel) runs it unchanged.

``platt_fit`` is NumPy, copied as it is; the head folds act on the port's
torch parameter dicts and return new dicts (the input is not modified).
"""

from __future__ import annotations

import logging
from typing import Dict, Tuple

import numpy as np
import torch

__all__ = ["platt_fit", "platt_apply", "calibrate_lstm_head",
           "calibrate_gnn_head", "calibrate_bert_head"]

logger = logging.getLogger(__name__)


def _bce(z: np.ndarray, y: np.ndarray, a: float, b: float) -> float:
    p = 1.0 / (1.0 + np.exp(-(a * z + b)))
    eps = 1e-12
    return float(-(y * np.log(p + eps)
                   + (1.0 - y) * np.log(1.0 - p + eps)).mean())


def platt_fit(logits: np.ndarray, labels: np.ndarray,
              iters: int = 2000, lr: float = 0.1,
              tol: float = 1e-7) -> Tuple[float, float]:
    """Fit (a, b) of ``p = sigmoid(a*z + b)`` by BCE gradient descent on
    held-out logits, deterministic, from the identity (a=1, b=0).

    The fit runs on standardised logits (class weighting shifts the raw
    logit mean far from 0, and on uncentred data the coupled (a, b)
    gradients crawl); the standardised solution (a', b') folds back exactly:
    ``a = a'/sd, b = b' - a'*mu/sd``. It iterates to convergence (parameter
    step < ``tol``) and falls back to the identity, with a warning, when the
    fit is unusable: a fitted ``a <= 0`` (it would invert the branch's
    ranking) or no BCE improvement over the identity.
    """
    z = np.asarray(logits, np.float64).ravel()
    y = np.asarray(labels, np.float64).ravel()
    if z.size == 0:
        logger.warning("platt_fit: empty calibration slice; "
                       "falling back to identity")
        return 1.0, 0.0
    with np.errstate(invalid="ignore", over="ignore"):
        mu = float(z.mean())
        sd = float(z.std())
    if not np.isfinite(mu) or not np.isfinite(sd):
        logger.warning("platt_fit: non-finite logits; "
                       "falling back to identity")
        return 1.0, 0.0
    if sd < 1e-12:
        sd = 1.0           # constant logits: only b is identifiable
    zs = (z - mu) / sd
    # the identity in standardised space: a'=sd, b'=mu  ->  a=1, b=0
    a_s, b_s = sd, mu
    for _ in range(iters):
        p = 1.0 / (1.0 + np.exp(-(a_s * zs + b_s)))
        g = p - y
        da = lr * float((g * zs).mean())
        db = lr * float(g.mean())
        a_s -= da
        b_s -= db
        if abs(da) < tol and abs(db) < tol:
            break
    # fold the standardisation back into (a, b): a*z + b == a_s*zs + b_s
    a = a_s / sd
    b = b_s - a_s * mu / sd
    if a <= 0.0:
        logger.warning(
            "platt_fit: fitted a=%.4f <= 0 would invert the branch's "
            "ranking; falling back to identity", a)
        return 1.0, 0.0
    if _bce(z, y, a, b) > _bce(z, y, 1.0, 0.0):
        logger.warning(
            "platt_fit: fit did not improve BCE over identity "
            "(%.5f vs %.5f); falling back to identity",
            _bce(z, y, a, b), _bce(z, y, 1.0, 0.0))
        return 1.0, 0.0
    return float(a), float(b)


def platt_apply(logits: np.ndarray, a: float, b: float) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-(a * np.asarray(logits, np.float64) + b)))


def calibrate_lstm_head(params: Dict[str, torch.Tensor], a: float,
                        b: float) -> Dict[str, torch.Tensor]:
    """Fold (a, b) into the LSTM's final dense (``w_head2``): z' = a*z + b,
    so ``sigmoid(lstm_logits(calibrated, x))`` is the calibrated
    probability."""
    return {**params,
            "w_head2": params["w_head2"] * a,
            "b_head2": params["b_head2"] * a + b}


def calibrate_gnn_head(params: Dict[str, torch.Tensor], a: float,
                       b: float) -> Dict[str, torch.Tensor]:
    """The same fold for the GraphSAGE head (``w_head2``)."""
    return {**params,
            "w_head2": params["w_head2"] * a,
            "b_head2": params["b_head2"] * a + b}


def calibrate_bert_head(params: Dict, a: float, b: float) -> Dict:
    """Fold into the 2-logit classifier: the branch score is
    ``z = logit[1] - logit[0]``; scaling both columns by ``a`` and adding
    ``b`` to class 1's bias gives z' = a*z + b."""
    clf = params["classifier"]
    new_b = clf["b"] * a
    new_b[1] += b
    return {**params, "classifier": {"w": clf["w"] * a, "b": new_b}}
