"""Full-graph GCN/GAT training (port of
``falcon_ttdforgnns_tpu/train/full_graph.py``, the reference's arxiv
recipe ``gcn_gat_partition.py``).

Every step materialises all node embeddings through the TT lookup (on the
card ``TTLookup``: ``tt_fwd`` forward, ``tt_grads`` backward), or the dense
table's rows under ``--no-tt``, optionally
appends the masked label one-hots (the label trick, built on the device
from an (N,) mask), runs the GNN over the whole COO graph, and takes one
AdamW step over every parameter, the TT cores included, with the
reference's linear warmup.  The loss is the reference's log-eps cross
entropy averaged over the prediction half of the train split; the split is
redrawn each epoch by ``numpy.random.default_rng(seed + epoch)``, as in the
reference.  GCN aggregates with ``index_add_`` (``--spmm xla``) or through
the window-blocked kernel (``--spmm blocked``, forward and backward).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..graph.csr import NodeDataset
from ..models.gat import GAT
from ..models.gcn import GCN
from ..models.sage import make_embed_layer
from ..ops.spmm_blocked import BlockedSpmm, build_blocked_spmm, default_blocked_tiling
from ..utils import resolve_device
from .optim import adam_init, adam_update

LOG_EPS = 1 - math.log(2)


def log_eps_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          reduction: str = "mean") -> torch.Tensor:
    """log(eps + CE) - log(eps), eps = 1 - log 2: the reference's smoothed
    cross entropy (``gcn_gat_partition.py:53-58``)."""
    ce = F.cross_entropy(logits, labels, reduction="none")
    y = torch.log(LOG_EPS + ce) - math.log(LOG_EPS)
    return y.mean() if reduction == "mean" else y


def warmup_lr(step: int, lr: float, warmup_epochs: int) -> float:
    """The reference's warmup as the JAX trainer schedules it:
    ``optax.join_schedules([linear_schedule(lr/W, lr, max(W-1, 1)),
    constant_schedule(lr)], [max(W-1, 1)])`` at ``step`` (counted from 0, so
    step 0 trains at lr/W), in f32 as optax evaluates it."""
    W = max(warmup_epochs, 1)
    B = max(W - 1, 1)
    if step >= B:
        return lr
    frac = np.float32(1.0) - np.float32(step) / np.float32(B)
    return float(np.float32(lr / W - lr) * frac + np.float32(lr))


class FullGraphModel(nn.Module):
    """TT embedding + full-graph GNN in one module, so one parameter list
    covers both."""

    def __init__(self, model_type: str, num_nodes: int, in_dim: int, hidden_dim: int,
                 num_classes: int, num_layers: int = 3, num_heads: int = 3,
                 dropout: float = 0.5, use_linear: bool = False, use_labels: bool = False,
                 use_tt: bool = True, tt_ranks: Sequence[int] = (16, 16),
                 p_shapes: Optional[Sequence[int]] = None,
                 q_shapes: Optional[Sequence[int]] = None,
                 weight_dist: str = "approx-normal", precomputed_cores=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if model_type not in ("gcn", "gat"):
            raise ValueError(f"model_type must be gcn or gat, got {model_type!r}")
        self.model_type, self.num_nodes, self.use_labels = model_type, num_nodes, use_labels
        self.embed = make_embed_layer(num_nodes, in_dim, use_tt, tt_ranks, p_shapes,
                                      q_shapes, weight_dist,
                                      precomputed_cores=precomputed_cores,
                                      generator=generator)
        gin = in_dim + (num_classes if use_labels else 0)
        if model_type == "gcn":
            self.gnn = GCN(gin, hidden_dim, num_classes, num_layers, dropout, use_linear,
                           generator=generator)
        else:
            self.gnn = GAT(gin, hidden_dim, num_classes, num_layers, num_heads, dropout,
                           use_linear=use_linear, generator=generator)

    def forward(self, src: torch.Tensor, dst: torch.Tensor, in_deg: torch.Tensor,
                label_onehot: Optional[torch.Tensor] = None, train: bool = False,
                blocked: Optional[BlockedSpmm] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits of every node: the embedding of ALL rows (plus the masked
        label one-hots), then the GNN over the full COO graph."""
        ids = torch.arange(self.num_nodes, dtype=torch.int32, device=src.device)
        feat = self.embed(ids)
        if self.use_labels:
            feat = torch.cat([feat, label_onehot], dim=-1)
        if self.model_type == "gcn":
            return self.gnn(feat, src, dst, in_deg, train, blocked, generator)
        return self.gnn(feat, src, dst, in_deg, train, generator)

    def materialize_features(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embed(ids)


@dataclass
class FullGraphConfig:
    """The JAX package's FullGraphConfig, field for field."""

    model: str = "gcn"
    epochs: int = 200
    lr: float = 0.005
    weight_decay: float = 0.0
    dropout: float = 0.5
    hidden_dim: int = 256
    num_layers: int = 3
    num_heads: int = 3
    use_linear: bool = False
    use_labels: bool = False
    use_tt: bool = True
    tt_ranks: Tuple[int, ...] = (16, 16)
    p_shapes: Optional[Tuple[int, ...]] = None
    q_shapes: Optional[Tuple[int, ...]] = None
    weight_dist: str = "approx-normal"
    warmup_epochs: int = 50
    mask_rate: float = 0.5
    eval_every: int = 10
    spmm: str = "xla"  # gcn: "xla" (index_add_) or "blocked" (window-gather kernel)
    seed: int = 0


class FullGraphTrainer:
    def __init__(self, dataset: NodeDataset, config: FullGraphConfig, logger=None,
                 precomputed_cores=None, device="cuda"):
        cfg = config
        if cfg.spmm not in ("xla", "blocked"):
            raise ValueError(f"full-graph trainer supports spmm 'xla' or 'blocked', got "
                             f"{cfg.spmm!r} ('pallas' is the SAGE eval tiled kernel)")
        if cfg.spmm == "blocked" and cfg.model != "gcn":
            raise ValueError("--spmm blocked serves GCN; GAT attention is per-step-"
                             "weighted (static tilings cannot carry the softmax weights)")
        self.ds, self.cfg, self.logger = dataset, cfg, logger
        self.device = resolve_device(device)
        n = dataset.num_nodes
        self.model = FullGraphModel(
            cfg.model, n, dataset.feat_dim, cfg.hidden_dim, dataset.num_classes,
            cfg.num_layers, cfg.num_heads, cfg.dropout, cfg.use_linear, cfg.use_labels,
            cfg.use_tt, cfg.tt_ranks, cfg.p_shapes, cfg.q_shapes, cfg.weight_dist,
            precomputed_cores,
            generator=torch.Generator().manual_seed(cfg.seed)).to(self.device)

        src, dst = dataset.graph.to_coo()
        self.blocked = None
        if cfg.spmm == "blocked":
            tile, ct = default_blocked_tiling(self.device)
            self.blocked = build_blocked_spmm(src.astype(np.int64), dst.astype(np.int64), n,
                                              tile=tile, dst_buckets=16, chunk_tiles=ct,
                                              device=self.device)
        self.src = torch.as_tensor(src.astype(np.int64), device=self.device)
        self.dst = torch.as_tensor(dst.astype(np.int64), device=self.device)
        self.in_deg = torch.as_tensor(dataset.graph.degrees.astype(np.float32),
                                      device=self.device)
        self.labels = torch.as_tensor(dataset.labels.astype(np.int64), device=self.device)
        self.params = list(self.model.parameters())
        self.opt_state = adam_init(self.params)
        self.dropout_gen = torch.Generator(device=self.device)
        self._eval_label_mask = None
        self.step = 0

    def _label_onehot(self, label_mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """(N, C) one-hots of the masked labels, built on the device from the
        (N,) mask (a label outside [0, C) gives a zero row)."""
        if label_mask is None:
            return None
        classes = torch.arange(self.ds.num_classes, device=self.device)
        return (self.labels[:, None] == classes).float() * label_mask[:, None]

    def _mask(self, idx: np.ndarray) -> torch.Tensor:
        m = np.zeros(self.ds.num_nodes, np.float32)
        m[idx] = 1.0
        return torch.as_tensor(m, device=self.device)

    def train_step(self, pred_mask: torch.Tensor,
                   label_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """One AdamW step on the masked log-eps loss; returns the loss as a
        device scalar."""
        logits = self.model(self.src, self.dst, self.in_deg, self._label_onehot(label_mask),
                            train=True, blocked=self.blocked, generator=self.dropout_gen)
        y = log_eps_cross_entropy(logits, self.labels, reduction="none")
        loss = (y * pred_mask).sum() / torch.clamp(pred_mask.sum(), min=1.0)
        grads = torch.autograd.grad(loss, self.params)
        lr = warmup_lr(self.step, self.cfg.lr, self.cfg.warmup_epochs)
        adam_update(self.params, grads, self.opt_state, lr, 1.0, self.cfg.weight_decay)
        self.step += 1
        return loss.detach()

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed + epoch)
        tr = self.ds.train_idx
        mask = rng.random(len(tr)) < cfg.mask_rate  # the 50% split (gcn_gat_partition.py:104-116)
        label_idx, pred_idx = tr[mask], tr[~mask]
        if not cfg.use_labels:
            pred_idx = tr[mask]
        t0 = time.perf_counter()
        self.dropout_gen.manual_seed(cfg.seed * 131 + epoch)
        loss = float(self.train_step(self._mask(pred_idx),
                                     self._mask(label_idx) if cfg.use_labels else None))
        dt = time.perf_counter() - t0
        return {"loss": loss, "epoch_time": dt, "edges_per_s": self.ds.graph.num_edges / dt}

    @torch.no_grad()
    def logits(self) -> torch.Tensor:
        """Eval-mode logits of every node, the label trick fed with the
        whole train split."""
        if self.cfg.use_labels and self._eval_label_mask is None:
            self._eval_label_mask = self._mask(self.ds.train_idx)
        return self.model(self.src, self.dst, self.in_deg,
                          self._label_onehot(self._eval_label_mask), train=False,
                          blocked=self.blocked)

    def evaluate(self) -> Dict[str, float]:
        pred = self.logits().argmax(-1).cpu().numpy()
        lab = self.ds.labels
        return {f"{s}_acc": float((pred[i] == lab[i]).mean())
                for s, i in [("train", self.ds.train_idx), ("val", self.ds.val_idx),
                             ("test", self.ds.test_idx)]}

    def checkpoint_state(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """(variables, opt_state) as ``save_checkpoint`` takes them: the
        model's ``state_dict`` and the AdamW state (the trainer's own
        tensors)."""
        return {"model": self.model.state_dict()}, {"adam": vars(self.opt_state)}

    def fit(self, epochs: Optional[int] = None) -> Dict[str, Any]:
        cfg = self.cfg
        epochs = epochs or cfg.epochs
        best = {"val_acc": 0.0, "test_acc": 0.0}
        history = []
        for epoch in range(epochs):
            stats = self.train_epoch(epoch)
            if (epoch + 1) % cfg.eval_every == 0 or epoch == epochs - 1:
                stats.update(self.evaluate())
                if stats["val_acc"] >= best["val_acc"]:
                    best = {"val_acc": stats["val_acc"], "test_acc": stats["test_acc"],
                            "epoch": epoch}
            history.append(stats)
            if self.logger and (epoch + 1) % cfg.eval_every == 0:
                self.logger.info(f"epoch {epoch}: {stats}")
        return {"history": history, "best": best}
