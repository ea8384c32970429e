"""Evaluation metric dispatch: ``accuracy``, ``f1_score`` and
``get_evaluator`` of ``falcon_ttdforgnns_tpu/utils/evaluator.py``, copied
(numpy only; parity with the reference's ``graphloader.py:23-30``
``get_evaluator``: ACC, F1, or the OGB Evaluator, which gives accuracy where
``ogb`` is not installed)."""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np


def accuracy(y_pred: np.ndarray, y_true: np.ndarray) -> float:
    return float((np.asarray(y_pred) == np.asarray(y_true)).mean())


def f1_score(y_pred: np.ndarray, y_true: np.ndarray,
             average: str = "macro") -> float:
    """Multi-class F1 without sklearn."""
    y_pred, y_true = np.asarray(y_pred), np.asarray(y_true)
    classes = np.unique(np.concatenate([y_true, y_pred]))
    f1s, supports = [], []
    for c in classes:
        tp = float(((y_pred == c) & (y_true == c)).sum())
        fp = float(((y_pred == c) & (y_true != c)).sum())
        fn = float(((y_pred != c) & (y_true == c)).sum())
        denom = 2 * tp + fp + fn
        f1s.append(2 * tp / denom if denom > 0 else 0.0)
        supports.append(float((y_true == c).sum()))
    f1s, supports = np.array(f1s), np.array(supports)
    if average == "macro":
        return float(f1s.mean())
    if average == "weighted":
        return float((f1s * supports).sum() / max(supports.sum(), 1.0))
    # micro == accuracy for single-label multi-class
    return accuracy(y_pred, y_true)


def get_evaluator(name: str = "acc", dataset: str = "") -> Callable[[np.ndarray, np.ndarray], float]:
    """acc | f1 | f1-micro | ogb (falls back to acc when ogb is absent)."""
    if name == "acc":
        return accuracy
    if name == "f1":
        return lambda p, t: f1_score(p, t, "macro")
    if name == "f1-micro":
        return lambda p, t: f1_score(p, t, "micro")
    if name == "ogb":
        try:
            from ogb.nodeproppred import Evaluator  # gated

            ev = Evaluator(name=dataset)

            def run(y_pred, y_true):
                return ev.eval({"y_pred": np.asarray(y_pred)[:, None],
                                "y_true": np.asarray(y_true)[:, None]})["acc"]

            return run
        except Exception:
            return accuracy
    raise ValueError(f"unknown evaluator {name!r}")
