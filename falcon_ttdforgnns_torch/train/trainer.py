"""Sampled-minibatch GraphSAGE training loop (``--mode mixed``).

Port of ``falcon_ttdforgnns_tpu/train/trainer.py:SageTrainer``: the host
sampler feeds static-shape batches to one train step per batch;
evaluation is full-graph propagation.  The step runs eagerly, one step per
call (the JAX package's multi-step ``fori_loop`` has no counterpart here,
so ``steps_per_call`` is accepted and has no effect).

Two step bodies, as in the JAX trainer:

* ``--sparse`` (fused, ``trainer.py:627-716``): the TT lookup runs without
  autograd (``tt_fwd``); the conv tower and the loss backprop to ``h_all``
  as a leaf; the dense params take Adam with the plateau scale; then the
  fused core update — ``tt_grads`` and ``tt_adam_apply`` — with
  ``scal = [lr * plateau_scale, 1/(1-b1^t), 1/(1-b2^t)]`` kept on the device.
* otherwise (``trainer.py:573-596``): autograd reaches the cores through
  :class:`TTLookup` (``tt_grads`` as its backward) and one Adam updates
  every param.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..graph.csr import NodeDataset
from ..graph.sampler import NeighborLoader
from ..models.sage import SAGE, collect_level_ids
from ..ops.tt_kernels import tt_fused_adam, tt_fwd
from ..utils import resolve_device
from ..utils.metrics import throughput
from .optim import (ADAM_B1, ADAM_B2, ADAM_EPS, adam_init, adam_update,
                    auto_plateau_patience, bias_corrections, plateau_init,
                    reduce_on_plateau)


@dataclass
class TrainConfig:
    """The JAX package's TrainConfig, field for field; values this port
    does not run yet raise ``NotImplementedError`` in :class:`SageTrainer`."""

    batch_size: int = 1024
    fanouts: Tuple[int, ...] = (5, 10, 15)
    epochs: int = 2
    lr: float = 0.003
    weight_decay: float = 0.0
    dropout: float = 0.5
    hidden_dim: int = 256
    num_layers: int = 3
    use_tt: bool = True
    tt_ranks: Tuple[int, ...] = (16, 16)
    p_shapes: Optional[Tuple[int, ...]] = None
    q_shapes: Optional[Tuple[int, ...]] = None
    weight_dist: str = "approx-normal"
    cache_size: int = 0
    tt_optimizer: str = "adam"
    plateau_patience: int = -1   # -1 = auto (800 in f32), 0 = off
    plateau_rtol: float = 1e-4
    plateau_smooth: float = 0.0
    eval_every: int = 1
    log_every: int = 20
    seed: int = 0
    inference_chunk: int = 65536
    edge_chunk: int = 1 << 22
    spmm: str = "xla"
    access_counts: bool = False
    skip_eval: bool = False
    dist: bool = False
    num_chips: int = -1
    data_shards: int = -1
    bf16: bool = False
    bf16_tower: bool = False
    bf16_kernel: bool = False
    bf16_mean_f32: bool = False
    bf16_sr: bool = False
    bf16_f32_head: bool = False
    bf16_f32_first: bool = False
    steps_per_call: int = 8
    sparse: bool = False
    batch_count: int = 131072
    mode: str = "mixed"
    sampler: str = "csr"
    table_width: int = 32
    rng_impl: str = "threefry"
    num_workers: int = 1
    use_sample: bool = True
    grouped: bool = False
    node_shard: bool = False
    eval_sampled: bool = False
    eval_sample_max: int = 131072


def _check_supported(cfg: TrainConfig) -> None:
    missing = [
        (cfg.mode != "mixed", "--mode puregpu (ROADMAP A8)"),
        (cfg.dist or cfg.node_shard, "--dist/--node-shard (ROADMAP A16)"),
        (not cfg.use_sample, "--full-neighbor training (ROADMAP A14)"),
        (cfg.spmm != "xla", f"--spmm {cfg.spmm} (ROADMAP B7-B9)"),
        (cfg.cache_size > 0 or cfg.access_counts, "the hot-row cache (ROADMAP A12)"),
        (cfg.grouped, "--emb-name eff (ROADMAP A13)"),
        (not cfg.use_tt, "--no-tt dense embeddings (ROADMAP A3)"),
        (cfg.bf16 or cfg.bf16_tower or cfg.bf16_kernel or cfg.bf16_sr
         or cfg.bf16_mean_f32 or cfg.bf16_f32_head or cfg.bf16_f32_first,
         "the --bf16* precision modes (ROADMAP A9)"),
        (cfg.eval_sampled, "--eval-sampled (ROADMAP A17)"),
        (cfg.tt_optimizer != "adam",
         f"--tt-optimizer {cfg.tt_optimizer} (ROADMAP B5/B6)"),
    ]
    for unsupported, what in missing:
        if unsupported:
            raise NotImplementedError(f"{what} is not ported yet")


class _EpochMeter:
    """Per-epoch bookkeeping: loss/acc device scalars accumulate unsynced
    (one host sync per log window), a throttled throughput log line, and
    the epoch summary."""

    def __init__(self, trainer: "SageTrainer", epoch: int):
        self._tr, self._epoch = trainer, epoch
        self._losses: List[torch.Tensor] = []
        self._accs: List[torch.Tensor] = []
        self._n_seen = 0
        self._window = 0
        self._t_epoch = time.perf_counter()
        self._t0 = self._t_epoch

    def record(self, loss, acc, n_samples: int, log_now: bool) -> None:
        self._losses.append(loss)
        self._accs.append(acc)
        self._n_seen += n_samples
        self._window += n_samples
        if not log_now:
            return
        loss_f, acc_f = float(loss), float(acc)
        tput = throughput(self._window, time.perf_counter() - self._t0)
        tr = self._tr
        tr._metrics["loss"].append(loss_f)
        tr._metrics["throughput"].append(tput)
        if tr.logger:
            tr.logger.info(f"epoch {self._epoch} step {tr.step} loss {loss_f:.4f} "
                           f"acc {acc_f:.4f} {tput:.0f} samples/s")
        self._t0 = time.perf_counter()
        self._window = 0

    def summary(self) -> Dict[str, float]:
        losses = torch.stack(self._losses).tolist() if self._losses else []
        accs = torch.stack(self._accs).tolist() if self._accs else []
        epoch_time = time.perf_counter() - self._t_epoch
        return {
            "loss": float(np.mean(losses)) if losses else float("nan"),
            "train_acc": float(np.mean(accs)) if accs else float("nan"),
            "epoch_time": epoch_time,
            "samples_per_s": self._n_seen / epoch_time,
        }


class SageTrainer:
    def __init__(self, dataset: NodeDataset, config: TrainConfig, logger=None,
                 precomputed_cores=None, device="cuda"):
        _check_supported(config)
        self.ds, self.cfg, self.logger = dataset, config, logger
        self.device = resolve_device(device)
        cfg = config
        # params are drawn on the CPU from a seeded generator, then moved
        self.model = SAGE(
            num_nodes=dataset.num_nodes, in_dim=dataset.feat_dim,
            hidden_dim=cfg.hidden_dim, num_classes=dataset.num_classes,
            num_layers=cfg.num_layers, dropout=cfg.dropout, tt_ranks=cfg.tt_ranks,
            p_shapes=cfg.p_shapes, q_shapes=cfg.q_shapes,
            weight_dist=cfg.weight_dist, precomputed_cores=precomputed_cores,
            batch_count=cfg.batch_count,
            generator=torch.Generator().manual_seed(cfg.seed)).to(self.device)
        self.shapes = self.model.embed.shapes
        self.patience = auto_plateau_patience(cfg.plateau_patience)
        self.fused_sparse = cfg.sparse
        self.cores = list(self.model.embed.cores)
        dense = [p for n, p in self.model.named_parameters()
                 if not n.startswith("embed.")]
        # routed Adam: the dense params, plus the cores when no fused update
        self.opt_params = dense if self.fused_sparse else list(self.model.parameters())
        self.opt_state = adam_init(self.opt_params)
        self.plateau = plateau_init(self.device)
        # fused-Adam moments of the cores and their step count t
        self.tt_opt = adam_init(self.cores) if self.fused_sparse else None
        self.loader = NeighborLoader(dataset.graph, dataset.train_idx,
                                     dataset.labels, cfg.fanouts, cfg.batch_size,
                                     seed=cfg.seed, num_workers=cfg.num_workers)
        self.dropout_gen = torch.Generator(device=self.device)
        self.dropout_gen.manual_seed(cfg.seed + 1000)
        self._eval_args = None
        self._metrics: Dict[str, List[float]] = {"loss": [], "throughput": []}
        self.step = 0

    # ------------------------------------------------------------------
    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device, non_blocking=True)

    def _plateau_scale(self, loss: torch.Tensor) -> torch.Tensor:
        if self.patience > 0:
            self.plateau = reduce_on_plateau(
                self.plateau, loss.detach(), patience=self.patience,
                rtol=self.cfg.plateau_rtol, smoothing=self.cfg.plateau_smooth)
        return self.plateau.scale

    def train_step(self, seeds, layers, labels) -> Tuple[torch.Tensor, torch.Tensor]:
        """One optimizer step on one sampled batch (host arrays or tensors);
        returns (loss, acc) as device scalars without a host sync."""
        cfg = self.cfg
        seeds, labels = self._tensor(seeds), self._tensor(labels).long()
        layers = [self._tensor(l) for l in layers]
        if self.fused_sparse:
            all_ids, _, _ = collect_level_ids(seeds, layers)
            all_ids = all_ids.to(torch.int32)
            with torch.no_grad():
                h_all = tt_fwd(self.shapes, [c.detach() for c in self.cores], all_ids)
            h_all.requires_grad_(True)
            logits = self.model.forward_from_embeddings(
                h_all, seeds, layers, train=True, generator=self.dropout_gen)
            loss = F.cross_entropy(logits, labels)
            d_h, *grads = torch.autograd.grad(loss, [h_all, *self.opt_params])
        else:
            logits = self.model(seeds, layers, train=True, generator=self.dropout_gen)
            loss = F.cross_entropy(logits, labels)
            grads = torch.autograd.grad(loss, self.opt_params)
        scale = self._plateau_scale(loss)
        adam_update(self.opt_params, grads, self.opt_state, cfg.lr, scale,
                    cfg.weight_decay)
        if self.fused_sparse:
            self.tt_opt.count += 1
            bc1, bc2 = bias_corrections(self.tt_opt.count)
            scal = torch.stack([cfg.lr * scale, 1.0 / bc1, 1.0 / bc2])
            tt_fused_adam(self.shapes, [c.detach() for c in self.cores],
                          self.tt_opt.m, self.tt_opt.v, all_ids, d_h.contiguous(),
                          scal, ADAM_B1, ADAM_B2, ADAM_EPS)
        acc = (logits.detach().argmax(-1) == labels).float().mean()
        return loss.detach(), acc

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        cfg = self.cfg
        self.dropout_gen.manual_seed(cfg.seed + 1000 + epoch)
        meter = _EpochMeter(self, epoch)
        for it, batch in enumerate(self.loader):
            loss, acc = self.train_step(batch.seeds, batch.layers, batch.labels)
            self.step += 1
            meter.record(loss, acc, cfg.batch_size,
                         log_now=(it + 1) % cfg.log_every == 0)
        return meter.summary()

    # ------------------------------------------------------------------
    @torch.no_grad()
    def evaluate(self) -> Dict[str, float]:
        """Split accuracies by full-graph propagation over every edge; three
        scalars come back to the host."""
        ds = self.ds
        if self._eval_args is None:
            src, dst = ds.graph.to_coo()
            self._eval_args = tuple(self._tensor(a) for a in (
                src.astype(np.int64), dst.astype(np.int64),
                ds.graph.degrees.astype(np.float32), ds.labels.astype(np.int64),
                ds.train_idx, ds.val_idx, ds.test_idx))
        src, dst, deg, labels, *splits = self._eval_args
        logits = self.model.forward_full_graph(src, dst, deg, train=False,
                                               chunk=self.cfg.edge_chunk)
        pred = logits.argmax(-1)
        accs = torch.stack([(pred[i] == labels[i]).float().mean() for i in splits])
        tr_a, va_a, te_a = accs.tolist()
        return {"train_acc": tr_a, "val_acc": va_a, "test_acc": te_a}

    def fit(self, epochs: Optional[int] = None) -> Dict[str, Any]:
        cfg = self.cfg
        epochs = epochs or cfg.epochs
        best = {"val_acc": 0.0, "test_acc": 0.0}
        history = []
        for epoch in range(epochs):
            stats = self.train_epoch(epoch)
            if not cfg.skip_eval and (
                    (epoch + 1) % cfg.eval_every == 0 or epoch == epochs - 1):
                stats.update(self.evaluate())
                if stats["val_acc"] >= best["val_acc"]:
                    best = {"val_acc": stats["val_acc"],
                            "test_acc": stats["test_acc"], "epoch": epoch}
            history.append(stats)
            if self.logger:
                self.logger.info(f"epoch {epoch}: {stats}")
        return {"history": history, "best": best, "metrics": self._metrics}
