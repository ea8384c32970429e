"""Sampled-minibatch GraphSAGE training loop (``--mode mixed`` and
``--mode puregpu``), which trains the sampled GAT of ``models/gat_ns.py``
(``model="gat"``, ``--model gat-ns``) through the same step.

Port of ``falcon_ttdforgnns_tpu/train/trainer.py:SageTrainer``.  Under
``--mode mixed`` the host sampler feeds static-shape batches to one train
step per batch.  Under ``--mode puregpu`` the CSR (or, with ``--sampler
table``, a prebuilt neighbour table) is placed on the device once, each
epoch's seeds and labels cross in one copy per group of
``steps_per_call`` batches, and every step samples its fan-out tree on the
device (``graph/device_sampler.py``) before the same step body.  Each
step runs eagerly, one step per call: the JAX package's multi-step
``fori_loop`` has no counterpart here, but its grouping does.  With
``steps_per_call`` S > 1 an epoch runs in groups of S steps, each group
recording its mean loss and accuracy on JAX's log cadence: a puregpu
epoch's groups are S batches of its seeds, copied to the device at once; a
mixed epoch's are S loader batches (JAX ``_grouped_batches``), the last
ragged group filled with the epoch's first batches again, so that an epoch
of nb batches is ceil(nb / S) * S steps, as in JAX.
Evaluation is full-graph propagation, its SpMM chosen by ``--spmm``:
``xla`` the CSR means over the row index of the trainer's one
:class:`ops.segment.FullGraph`, ``pallas`` the tiled kernel (B7),
``blocked`` the window-gather kernel (B9); ``infer_full`` returns the
logits it scores; ``--eval-sampled`` evaluates by the sampled fan-out
forward instead (:meth:`SageTrainer.evaluate_sampled`).  The reference takes its XLA route for ``pallas``
off a TPU; the port runs B7 on the card and its plain version on the CPU,
so the CPU tests reach the routing.

Two step bodies, as in the JAX trainer:

* ``--sparse`` without the hot-row cache (fused, ``trainer.py:627-716``):
  the step sorts its ids once (``grouped_order``) for the lookup and the
  core update; the TT lookup runs without autograd (``tt_fwd``, storing
  bf16 under ``--bf16``/``--bf16-kernel``, or ``tt_fwd_sr`` with
  ``--bf16-sr`` as well, seeded per step from a device generator); the
  conv tower and the loss backprop to ``h_all`` as a leaf
  (so ``d_h`` comes back in ``h_all``'s dtype); the dense params take Adam
  with the plateau scale; then the fused core update, ``tt_grads`` and one
  of: ``tt_adam_apply`` with ``scal = [lr * plateau_scale, 1/(1-b1^t),
  1/(1-b2^t)]`` kept on the device (``--tt-optimizer adam``), or
  ``tt_sgd_apply`` / ``tt_adagrad_apply`` with the fixed ``lr`` and no
  plateau scale (``sgd``, ``adagrad``, ``rowwise_adagrad``).
* otherwise (``trainer.py:573-596``): autograd reaches the cores through
  :class:`TTLookup` (``tt_grads`` as its backward; in f32 also under
  ``--bf16``, whose tower casts the rows); the dense params take Adam, the
  cores ``--tt-optimizer`` (one Adam for all when it is ``adam``) and the
  cache rows rowwise adagrad, every update times the plateau scale.

``--full-neighbor`` (``trainer.py:728-762, 1001-1030``) trains on the
exact neighbourhoods: each step runs the full-graph forward over every
edge (the lookup over all N ids, then one ``index_add_`` SpMM a layer) in
f32 with autograd, takes the loss on the batch's seeds, and updates as the
routed body does; the cores take routed Adam even under ``--sparse``, since
the fused update needs the sampled ids, as in JAX.  ``--no-tt`` (or
``--emb-name dense``) trains the dense (N, D) table with the dense params'
Adam, and ``--access-counts`` (without TT) counts its rows' accesses in the
step; the host loader counts under ``--access-counts`` as under the cache,
and :meth:`access_count_stats` reads either.

:meth:`save` and :meth:`restore` carry the whole state through a
checkpoint: the model's ``state_dict`` (the cache's rows and metadata, the
access counts), every optimizer's state, the plateau, the step, and what
carries across epochs (the SR store's generator, the host loader's
generator and counts), so that a restore at an epoch boundary continues as
the uninterrupted run would.

The hot-row cache (``--use-cached --cache-size K``, ``trainer.py:1032-1050``)
turns the fused body off, as JAX's ``_want_fused_sparse`` does.  Epoch 0
warms up: nothing hits, and the accesses are counted by the host loader
(``--mode mixed``) or in the step (``--mode puregpu``, ``device_freq``).
After it :meth:`maybe_populate_cache` caches the K most accessed ids'
rows and resets the cache group's optimizer state; later epochs serve the
hits from the cache.

``--dist`` (JAX ``trainer.py:279-357``) is data parallelism over the W
ranks of a ``torch.distributed`` process group
(``parallel/data_parallel.py``), taken when the group has more than one
rank (or is given explicitly).  Every rank holds the whole batch (the same
host loader, or the same in-step sampler stream) and steps on its rows of
it; the gradients of the local loss over W, the cores' ``tt_grads`` among
them, are summed by one all-reduce a step, with the loss and accuracy, so
that the step is the single-device step on the whole batch.  Mixed
``--dist`` turns the fused update off, as JAX does (``trainer.py:285-287``);
under puregpu the fused update is split around the all-reduce: ``tt_grads``,
the all-reduce, then ``tt_adam_apply`` (or ``tt_sgd_apply`` or
``tt_adagrad_apply``).  The access counters (``--access-counts``, the
puregpu cache's) count the whole batch on every rank.  Rank 0 alone logs;
``fit`` evaluates on rank 0 and broadcasts the accuracies.

``--node-shard`` (JAX ``trainer.py:360-400, 1121-1159``) shards the node
space over the node axis of a ``(data, node)`` mesh of the group
(``parallel/node_sharding.py``), taken when the group has more than one
rank (or is given explicitly); at world size 1 without a group it is the
single-device path, as JAX's ``device_count() > 1`` decides.  Under
``--full-neighbor`` each step is :meth:`node_sharded_step`: every rank
looks up its block's rows through the TT lookup, aggregates each layer by
the ring SpMM, takes the loss of the batch's seeds in its rows (under
``--dist``, of its data group's slice of the batch: the hybrid data x node
split) summed over the global batch size, and the gradients, the loss and
the accuracy of every rank are summed in one all-reduce before the routed
update.  There is no dropout on this path, as in JAX.  Evaluation and
:meth:`infer_full` take the ring too (:meth:`infer_full_sharded`), for
sampled training as well, whatever ``--spmm``; every rank evaluates.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..graph.csr import NodeDataset
from ..graph.device_sampler import (build_neighbor_table, device_sample_block,
                                    device_sample_block_table)
from ..graph.sampler import NeighborLoader, sample_block
from ..models.gat_ns import GATNS
from ..models.sage import SAGE, collect_level_ids
from ..nn.tt_embedding import AccessCountingEmbedding
from ..ops.segment import FullGraph
from ..ops.spmm_blocked import (build_window_tiles, chunk_tiles_host,
                                default_blocked_tiling, spmm_sum_blocked_dev)
from ..ops.spmm_tiled import auto_tile_edges, build_spmm_tiles_uniform, spmm_sum_tiled_uniform
from ..ops.tt_kernels import (grouped_order, tt_adagrad_apply, tt_adam_apply,
                              tt_fused_adagrad, tt_fused_adam, tt_fused_sgd, tt_fwd,
                              tt_fwd_sr, tt_grads, tt_sgd_apply)
from ..parallel.data_parallel import data_parallel_for
from ..parallel.mesh import rank
from ..parallel.node_sharding import NodeSharding, node_mesh_for, partition_edges_ragged
from ..utils import resolve_device
from ..utils.metrics import access_percentages, count, span, spanned, throughput
from .checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
from .optim import (ADAGRAD_EPS, ADAM_B1, ADAM_B2, ADAM_EPS, ROWWISE_ADAGRAD_EPS,
                    TT_OPTIMIZERS, adam_init, adam_update, auto_plateau_patience,
                    bias_corrections, cache_opt_init, cache_update, core_update,
                    plateau_init, reduce_on_plateau, reset_cache_opt_state, tt_acc_init)


# full-graph aggregation of evaluate(): "xla" the chunked index_add_ SpMM,
# "pallas" the tiled kernel (B7), "blocked" the window-gather kernel (B9)
SPMM_ROUTES = ("xla", "pallas", "blocked")
MODES = ("mixed", "puregpu")    # --mode: host sampling, or in-step on the device
SAMPLERS = ("csr", "table")     # --sampler of --mode puregpu
MODELS = ("sage", "gat")        # TrainConfig.model: GraphSAGE, or the sampled GAT
EVAL_KEYS = ("train_acc", "val_acc", "test_acc")


@dataclass
class TrainConfig:
    """The JAX package's TrainConfig, field for field, and two fields of
    the port's own, ``model`` and ``num_heads``: "sage" trains GraphSAGE,
    "gat" the sampled GAT of ``models/gat_ns.py`` with ``num_heads``
    heads of ``hidden_dim`` (``--model gat-ns``); values this port does not
    run yet raise ``NotImplementedError`` in :class:`SageTrainer`."""

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
    plateau_patience: int = -1   # -1 = auto (800 in f32, 0 under a bf16 tower), 0 = off
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
    node_shard: bool = False
    eval_sampled: bool = False
    eval_sample_max: int = 131072
    model: str = "sage"
    num_heads: int = 4


def _check_supported(cfg: TrainConfig) -> None:
    if cfg.dist and not cfg.use_sample and not cfg.node_shard:
        raise ValueError("--dist is a sampled-minibatch DP path; "
                         "full-neighbor training scales out via "
                         "--node-shard (optionally combined with "
                         "--dist for the hybrid data x node mesh)")
    if cfg.mode not in MODES or cfg.sampler not in SAMPLERS:
        raise ValueError(f"unknown mode {cfg.mode!r} or sampler {cfg.sampler!r}; "
                         f"expected one of {MODES} and of {SAMPLERS}")
    if cfg.tt_optimizer not in TT_OPTIMIZERS:
        raise ValueError(f"unknown tt_optimizer {cfg.tt_optimizer!r}")
    if cfg.spmm not in SPMM_ROUTES:
        raise ValueError(f"unknown spmm {cfg.spmm!r}; expected one of {SPMM_ROUTES}")
    if cfg.model not in MODELS or cfg.num_heads < 1:
        raise ValueError(f"unknown model {cfg.model!r} ({cfg.num_heads} heads); expected "
                         f"one of {MODELS}")
    if cfg.model == "gat":
        refused = [flag for flag, on in (
            ("--node-shard", cfg.node_shard), (f"--spmm {cfg.spmm}", cfg.spmm != "xla"),
            ("--eval-sampled", cfg.eval_sampled), ("--full-neighbor", not cfg.use_sample),
            ("--bf16-mean-f32", cfg.bf16_mean_f32), ("--bf16-f32-head", cfg.bf16_f32_head),
            ("--bf16-f32-first", cfg.bf16_f32_first)) if on]
        if refused:
            raise ValueError(f"the sampled GAT trains on sampled levels and evaluates "
                             f"through its CSR attention kernel (--spmm xla); it cannot "
                             f"take {', '.join(refused)}")


def _warn_inert_flags(cfg: TrainConfig, warn) -> None:
    """The bf16 sub-mode flags refine a bf16 base mode; one set without its
    prerequisite trains an unchanged config (JAX ``trainer.py:200-217``)."""
    if cfg.bf16_sr and not (cfg.bf16 or cfg.bf16_kernel):
        warn("--bf16-sr has no effect without --bf16/--bf16-kernel "
             "(the SR store targets the bf16 h_all); running unchanged")
    elif cfg.bf16_sr and not cfg.sparse:
        warn("--bf16-sr only applies to the fused --sparse path; the "
             "dense path ignores it and runs unchanged")
    if cfg.bf16_mean_f32 and not (cfg.bf16 or cfg.bf16_tower):
        warn("--bf16-mean-f32 has no effect without --bf16/--bf16-tower "
             "(the tower means are already f32); running unchanged")
    if (cfg.bf16_f32_head or cfg.bf16_f32_first) and not (cfg.bf16 or cfg.bf16_tower):
        warn("--bf16-f32-head/--bf16-f32-first have no effect without "
             "--bf16/--bf16-tower (the tower is already f32); running unchanged")
    if cfg.rng_impl == "rbg":
        warn("--rng-impl rbg names the TPU's hardware generator, which the card "
             "has not; the port draws from torch's Philox generator either way")


@dataclass
class FullGraphSpmm:
    """h -> A h over the full graph through one ``--spmm`` route's kernel:
    "pallas" the uniform tiling and B7, "blocked" the window tiling and B9."""

    route: str
    arrays: Tuple[torch.Tensor, ...]  # the tiling, on the device
    meta: Tuple[int, ...]
    info: Dict[str, int]              # its chunk, tile and slot counts
    tiling_s: float                   # host seconds to build it

    def __call__(self, h: torch.Tensor) -> torch.Tensor:
        if self.route == "pallas":
            return spmm_sum_tiled_uniform(h, *self.arrays, *self.meta)
        return spmm_sum_blocked_dev(h, *self.arrays, *self.meta)


def _wrap_full(pick: np.ndarray, order: np.ndarray, size: int) -> np.ndarray:
    """Extend a ragged tail to exactly ``size`` ids by wrapping around the
    epoch order, cyclically, so it stays full even when the whole order is
    shorter than one group (JAX ``trainer.py:550-557``)."""
    if len(pick) == size:
        return pick
    return np.resize(np.concatenate([pick, order]), size)


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
        with span("trainer.log"):
            count("trainer.host_reads", 2)
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
        with span("trainer.log"):
            count("trainer.host_reads", 2 if self._losses else 0)
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
    """``group`` is the process group of ``--dist`` and ``--node-shard``
    (the default group without one, whose world size decides as JAX's
    device count does); one given explicitly takes their multi-rank path
    at any world size."""

    def __init__(self, dataset: NodeDataset, config: TrainConfig, logger=None,
                 precomputed_cores=None, device="cuda", group=None):
        _check_supported(config)
        cfg = config
        self.ds, self.cfg = dataset, config
        self.device = resolve_device(device)
        self.dp = data_parallel_for(cfg, self.device, group)
        self.node_mesh = node_mesh_for(cfg, self.device, group)
        self.nshard: Optional[NodeSharding] = None
        self.nshard_layout_s = None  # host seconds to build the layout
        # rank 0 alone logs
        quiet = (self.dp is not None or self.node_mesh is not None) and rank(group) > 0
        self.logger = logger = None if quiet else logger
        self._indptr_dev = self._indices_dev = self._table_dev = None
        if cfg.mode == "puregpu":
            self._put_graph_on_device()
        warn = ((lambda m: None) if quiet else logger.warning if logger
                else (lambda m: print(m, file=sys.stderr)))
        _warn_inert_flags(cfg, warn)
        bf16_tower = cfg.bf16 or cfg.bf16_tower
        # params are drawn on the CPU from a seeded generator, then moved
        common = dict(
            num_nodes=dataset.num_nodes, in_dim=dataset.feat_dim,
            hidden_dim=cfg.hidden_dim, num_classes=dataset.num_classes,
            num_layers=cfg.num_layers, dropout=cfg.dropout, use_tt=cfg.use_tt,
            tt_ranks=cfg.tt_ranks, p_shapes=cfg.p_shapes, q_shapes=cfg.q_shapes,
            weight_dist=cfg.weight_dist, cache_size=cfg.cache_size,
            access_counts=cfg.access_counts,
            precomputed_cores=precomputed_cores, batch_count=cfg.batch_count,
            generator=torch.Generator().manual_seed(cfg.seed),
            # --full-neighbor aggregates over true degrees: f32, as in JAX
            bf16=bf16_tower and cfg.use_sample,
            # in-step sampling: the host loader never runs, so the step counts
            device_freq=cfg.mode == "puregpu" and cfg.cache_size > 0)
        if cfg.model == "gat":
            self.model = GATNS(num_heads=cfg.num_heads, **common).to(self.device)
        else:
            self.model = SAGE(mean_acc_f32=cfg.bf16_mean_f32, bf16_f32_head=cfg.bf16_f32_head,
                              bf16_f32_first=cfg.bf16_f32_first, **common).to(self.device)
        self.shapes = self.model.embed.shapes if cfg.use_tt else None
        self.patience = auto_plateau_patience(cfg.plateau_patience, bf16_tower)
        if bf16_tower and cfg.plateau_patience < 0 and logger:
            logger.info("bf16 tower: reduce-on-plateau auto-disabled (its ratchet "
                        "reads bf16 loss noise as a plateau); pass "
                        "--plateau-patience to force it on")
        # a cache, the dense table, --full-neighbor or mixed --dist turns the
        # fused update off (JAX _want_fused_sparse and trainer.py:285-287)
        fusable = cfg.sparse and cfg.use_tt and cfg.cache_size == 0
        self.fused_sparse = fusable and cfg.use_sample and (
            cfg.mode == "puregpu" or self.dp is None)
        if fusable and not cfg.use_sample:
            warn("--full-neighbor: the fused --sparse update needs sampled ids, so the "
                 "TT cores take the routed optimizer")
        self.cores = list(self.model.embed.cores) if cfg.use_tt else []
        # the dense params, the --no-tt table among them
        dense = [p for n, p in self.model.named_parameters()
                 if not n.startswith(("embed.tt_core_", "embed.cache_weight"))]
        # routed Adam: the dense params, plus the cores when neither a fused
        # update nor another routed core optimizer takes them
        self.routed_cores = not self.fused_sparse and cfg.tt_optimizer != "adam"
        self.opt_params = (dense if self.fused_sparse or self.routed_cores
                           else dense + self.cores)
        self.opt_state = adam_init(self.opt_params)
        # the cache rows' group: rowwise adagrad at lr (JAX make_optimizer's defaults)
        self.cache_weight = self.model.embed.cache_weight if cfg.cache_size > 0 else None
        self.cache_opt = (cache_opt_init(self.cache_weight, lr=cfg.lr)
                          if self.cache_weight is not None else None)
        self.plateau = plateau_init(self.device)
        # fused-Adam moments of the cores and their step count t
        self.tt_opt = (adam_init(self.cores)
                       if self.fused_sparse and cfg.tt_optimizer == "adam" else None)
        # adagrad accumulators of the cores (fused or routed)
        self.tt_acc = tt_acc_init(self.cores, cfg.tt_optimizer)
        # bf16 kernel I/O of the fused step: h_all stored bf16, d_h read bf16
        self.h_dtype = torch.bfloat16 if cfg.bf16 or cfg.bf16_kernel else torch.float32
        self.sr_gen = torch.Generator(device=self.device)
        self.sr_gen.manual_seed(cfg.seed + 0x5EED)
        # the host counts feed the cache's populate and access_count_stats
        self.loader = NeighborLoader(dataset.graph, dataset.train_idx,
                                     dataset.labels, cfg.fanouts, cfg.batch_size,
                                     seed=cfg.seed,
                                     track_freq=cfg.cache_size > 0 or cfg.access_counts,
                                     num_workers=cfg.num_workers)
        self.dropout_gen = torch.Generator(device=self.device)
        self.dropout_gen.manual_seed(cfg.seed + 1000)
        # --mode puregpu: the in-step sampler's own generator, reseeded each epoch
        self.sample_gen = torch.Generator(device=self.device)
        self.sample_gen.manual_seed(cfg.seed + 2000)
        if cfg.mode == "puregpu" and cfg.cache_size > 0 and logger:
            logger.warning("--mode puregpu samples on the device; host LFU counts are "
                           "unavailable, so the cache populates from the counts of the step")
        self._graph = self._labels = None
        if self.node_mesh is not None and not cfg.use_sample:
            self._ensure_nshard_layout(self.node_mesh.n_node)  # JAX places it here
        self._spmms: Dict[str, FullGraphSpmm] = {}
        self._metrics: Dict[str, List[float]] = {"loss": [], "throughput": []}
        self.step = 0

    # ------------------------------------------------------------------
    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device, non_blocking=True)

    def _put_graph_on_device(self) -> None:
        """``--mode puregpu`` placement (JAX ``trainer.py:447-486``, its
        sampling branch): ``indptr`` and ``indices`` as int32 on the device
        and, under ``--sampler table``, the (N, table_width) neighbour table
        built on the host from ``cfg.seed``.  A graph of 2^31 edges or more
        would wrap int32 offsets, so it raises before anything is placed."""
        g, cfg = self.ds.graph, self.cfg
        if g.num_edges >= 2**31:
            raise NotImplementedError(
                f"single-device graph placement needs < 2^31 edges, got {g.num_edges}; "
                f"use host sampling (--mode mixed), or --full-neighbor --node-shard "
                f"(block-local int32 edge indices)")
        self._indptr_dev = self._tensor(g.indptr.astype(np.int32, copy=False))
        self._indices_dev = self._tensor(g.indices.astype(np.int32, copy=False))
        if cfg.sampler == "table":
            self._table_dev = self._tensor(build_neighbor_table(
                g.indptr, g.indices, cfg.table_width, cfg.seed))

    def _plateau_scale(self, loss: torch.Tensor) -> torch.Tensor:
        if self.patience > 0:
            self.plateau = reduce_on_plateau(
                self.plateau, loss.detach(), patience=self.patience,
                rtol=self.cfg.plateau_rtol, smoothing=self.cfg.plateau_smooth)
        return self.plateau.scale

    def train_step(self, seeds, layers, labels) -> Tuple[torch.Tensor, torch.Tensor]:
        """One optimizer step on one sampled batch (host arrays or tensors);
        returns (loss, acc) as device scalars without a host sync."""
        with span("trainer.step"):
            seeds, labels = self._tensor(seeds), self._tensor(labels)
            return self._step(seeds, [self._tensor(l) for l in layers], labels)

    def sample_layers(self, seeds: torch.Tensor) -> List[torch.Tensor]:
        """``--mode puregpu``: the fan-out tree of ``seeds`` (on the device),
        sampled on the device from the placed CSR or neighbour table with
        ``sample_gen``; no host sync."""
        if self._indptr_dev is None:
            raise ValueError("in-step sampling needs --mode puregpu (the graph on the device)")
        with span("sampler.device"):
            if self._table_dev is not None:
                return device_sample_block_table(self._table_dev, seeds, self.cfg.fanouts,
                                                 self.sample_gen)
            return device_sample_block(self._indptr_dev, self._indices_dev, seeds,
                                       self.cfg.fanouts, self.sample_gen)

    def device_train_step(self, seeds: torch.Tensor,
                          labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One ``--mode puregpu`` step: sample on the device, then the step
        body of :meth:`train_step`; seeds and labels are device tensors."""
        with span("trainer.step"):
            return self._step(seeds, self.sample_layers(seeds), labels)

    def _step(self, seeds: torch.Tensor, layers: List[torch.Tensor],
              labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The one step body of both modes, on device tensors; under
        ``--dist`` on this rank's rows of the whole batch given."""
        cfg = self.cfg
        if self.dp is not None:
            self._count_other_rows(seeds, layers)
            seeds, layers, labels = self.dp.shard(seeds, layers, labels)
        labels = labels.long()
        if not self.fused_sparse:
            logits = self.model(seeds, layers, train=True, generator=self.dropout_gen)
            return self._routed_update(logits, labels)
        all_ids, _, _ = collect_level_ids(seeds, layers)
        all_ids = all_ids.to(torch.int32)
        with span("embed.sort"):
            order = grouped_order(all_ids)  # one sort a step, for tt_fwd and tt_grads
        cores = [c.detach() for c in self.cores]
        with torch.no_grad(), span("embed.lookup"):
            if self.h_dtype == torch.bfloat16 and cfg.bf16_sr:
                h_all = tt_fwd_sr(self.shapes, cores, all_ids, self._sr_seed(),
                                  order=order)
            else:
                h_all = tt_fwd(self.shapes, cores, all_ids, self.h_dtype, order=order)
        h_all.requires_grad_(True)
        logits = self.model.forward_from_embeddings(
            h_all, seeds, layers, train=True, generator=self.dropout_gen)
        loss = F.cross_entropy(logits, labels)
        acc = (logits.detach().argmax(-1) == labels).float().mean()
        with span("trainer.backward"):
            d_h, *grads = torch.autograd.grad(self._share(loss), [h_all, *self.opt_params])
        if self.dp is None:
            with span("optim.dense"):
                scale = self._plateau_scale(loss)
                adam_update(self.opt_params, grads, self.opt_state, cfg.lr, scale,
                            cfg.weight_decay)
            self._fused_core_update(cores, all_ids, d_h.contiguous(), scale, order)
            return loss.detach(), acc
        # --dist: the fused update split around the all-reduce, which takes
        # the cores' batch totals with the dense gradients
        core_grads = tt_grads(self.shapes, cores, all_ids, d_h.contiguous(), order=order)
        loss, acc, grads = self.dp.all_reduce(loss, acc, [*grads, *core_grads])
        n = len(self.opt_params)
        with span("optim.dense"):
            scale = self._plateau_scale(loss)
            adam_update(self.opt_params, grads[:n], self.opt_state, cfg.lr, scale,
                        cfg.weight_decay)
        self._core_apply(cores, grads[n:], scale)
        return loss, acc

    def _share(self, loss: torch.Tensor) -> torch.Tensor:
        """The loss the backward starts from: the step's, or under ``--dist``
        this rank's share of the global mean."""
        return loss if self.dp is None else self.dp.share(loss)

    def _count_other_rows(self, seeds: torch.Tensor, layers: List[torch.Tensor]) -> None:
        """``--dist``: count the other ranks' rows of the batch into the
        counters that the step's forward counts its own rows into
        (``--access-counts`` without TT, the puregpu cache's), so that they
        hold the whole batch's counts, as JAX's replicated collection does."""
        emb = self.model.embed
        if isinstance(emb, AccessCountingEmbedding):
            counts = emb.counts
        elif getattr(emb, "device_freq", False):
            counts = emb.cache_freq
        else:
            return
        ids = collect_level_ids(*self.dp.other_rows(seeds, layers))[0].long()
        counts.index_add_(0, ids, torch.ones_like(ids, dtype=counts.dtype))

    def _routed_update(self, logits: torch.Tensor,
                       labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The routed body's update from the step's logits (JAX
        ``trainer.py:573-596``): autograd to every trained tensor, then
        :meth:`_apply_update`."""
        loss = F.cross_entropy(logits, labels)
        acc = (logits.detach().argmax(-1) == labels).float().mean()
        with span("trainer.backward"):
            grads = torch.autograd.grad(self._share(loss), self._trained())
        if self.dp is not None:
            loss, acc, grads = self.dp.all_reduce(loss, acc, grads)
        return self._apply_update(loss, acc, grads)

    def _trained(self) -> List[torch.Tensor]:
        """What the routed update trains: the Adam group, then the cores
        when another optimizer takes them, then the cache rows."""
        routed = self.cores if self.routed_cores else []
        cache = [] if self.cache_weight is None else [self.cache_weight]
        return [*self.opt_params, *routed, *cache]

    def _apply_update(self, loss: torch.Tensor, acc: torch.Tensor,
                      grads: List[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Adam on the dense params (the cores too when they take Adam), the
        routed core optimizer, the cache group, all times the plateau
        scale of ``loss``, from the gradients of :meth:`_trained`."""
        cfg = self.cfg
        n = len(self.opt_params)
        m = n + (len(self.cores) if self.routed_cores else 0)
        grads, core_grads, cache_grads = grads[:n], grads[n:m], grads[m:]
        with span("optim.dense"):
            scale = self._plateau_scale(loss)
            adam_update(self.opt_params, grads, self.opt_state, cfg.lr, scale,
                        cfg.weight_decay)
            if self.routed_cores:
                core_update(self.cores, core_grads, self.tt_acc, cfg.tt_optimizer,
                            cfg.lr, scale)
            if self.cache_weight is not None:
                cache_update(self.cache_weight, cache_grads[0], self.cache_opt, scale)
        return loss.detach(), acc

    def full_neighbor_step(self, seeds: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One ``--full-neighbor`` step (JAX ``_build_full_neighbor_step``):
        the train-mode full-graph forward over every edge, the loss on the
        rows of ``seeds`` (a device tensor; their labels are gathered on the
        device), and the routed update."""
        with span("trainer.step"):
            labels = self._eval_labels()[0]
            logits = self.model.forward_full_graph(self._full_graph(), train=True,
                                                   generator=self.dropout_gen)
            return self._routed_update(logits.index_select(0, seeds),
                                       labels.index_select(0, seeds))

    def node_sharded_step(self, pick: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """One node-sharded ``--full-neighbor`` step (JAX
        ``make_node_sharded_full_step``) on the batch of node ids ``pick``
        (host), every rank of the group at once: :meth:`node_sharded_grads`,
        then the routed update.  Returns the global loss and accuracy."""
        with span("trainer.step"):
            return self._apply_update(*self.node_sharded_grads(pick))

    def node_sharded_grads(self, pick: np.ndarray):
        """The node-sharded step's global loss, accuracy and gradients of
        :meth:`_trained` on the batch ``pick``: the TT lookup of this rank's
        rows, the layers over the ring (no dropout, as in JAX), the loss of
        its seeds summed over the global batch size, the backward (the
        transposed rings carry each rank's share home), and one all-reduce
        of every rank's gradients, loss and accuracy."""
        ns = self.nshard
        rows, labels = ns.local_seeds(ns.layout.row_of[pick], self.ds.labels[pick])
        h = ns.propagate(self.model.materialize_features(ns.node_ids), self.model.apply_conv,
                         self.cfg.num_layers)
        loss, acc = ns.loss_shares(h.index_select(0, rows), labels, len(pick))
        grads = torch.autograd.grad(loss, self._trained())
        return ns.all_reduce(loss, acc, grads)

    def _sr_seed(self) -> torch.Tensor:
        """The SR store's seed for this step, drawn on the device (no host
        sync): a fresh dither every step, since a repeated one is a frozen
        bias.  torch's bits are not jax's, so parity with the JAX trainer
        holds per seed, not per step."""
        return torch.randint(0, 2**31 - 1, (), generator=self.sr_gen,
                             device=self.device, dtype=torch.int32)

    def _fused_core_update(self, cores, ids, d_h, scale, order) -> None:
        """``tt_grads`` and the in-place update of ``--tt-optimizer``: Adam
        with the plateau-scaled lr, or sgd/adagrad with the fixed lr (JAX
        ``trainer.py:673-707``); ``order`` is the step's sort of ``ids``."""
        cfg = self.cfg
        with span("optim.tt"):
            if cfg.tt_optimizer == "adam":
                tt_fused_adam(self.shapes, cores, self.tt_opt.m, self.tt_opt.v, ids, d_h,
                              self._adam_scal(scale), ADAM_B1, ADAM_B2, ADAM_EPS, order=order)
            elif cfg.tt_optimizer == "sgd":
                tt_fused_sgd(self.shapes, cores, ids, d_h, cfg.lr, order=order)
            else:
                rowwise = cfg.tt_optimizer == "rowwise_adagrad"
                tt_fused_adagrad(self.shapes, cores, self.tt_acc, ids, d_h, cfg.lr,
                                 ROWWISE_ADAGRAD_EPS if rowwise else ADAGRAD_EPS, rowwise,
                                 order=order)

    def _core_apply(self, cores, grads, scale) -> None:
        """``--dist``: the update of :meth:`_fused_core_update` from the
        all-reduced core gradients."""
        cfg = self.cfg
        with span("optim.tt"):
            if cfg.tt_optimizer == "adam":
                tt_adam_apply(cores, self.tt_opt.m, self.tt_opt.v, grads,
                              self._adam_scal(scale), ADAM_B1, ADAM_B2, ADAM_EPS)
            elif cfg.tt_optimizer == "sgd":
                tt_sgd_apply(cores, grads, cfg.lr)
            else:
                rowwise = cfg.tt_optimizer == "rowwise_adagrad"
                tt_adagrad_apply(cores, self.tt_acc, grads, cfg.lr,
                                 ROWWISE_ADAGRAD_EPS if rowwise else ADAGRAD_EPS, rowwise)

    def _adam_scal(self, scale: torch.Tensor) -> torch.Tensor:
        """The fused Adam's step count, advanced, and its
        ``[lr * plateau_scale, 1/(1-b1^t), 1/(1-b2^t)]`` on the device."""
        self.tt_opt.count += 1
        bc1, bc2 = bias_corrections(self.tt_opt.count)
        return torch.stack([self.cfg.lr * scale, 1.0 / bc1, 1.0 / bc2])

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        cfg = self.cfg
        self.dropout_gen.manual_seed(cfg.seed + 1000 + epoch)
        if not cfg.use_sample:
            return self._train_epoch_full_neighbor(epoch)
        if cfg.mode == "puregpu":
            return self._train_epoch_device(epoch)
        if cfg.steps_per_call > 1:
            return self._train_epoch_grouped(epoch)
        meter = _EpochMeter(self, epoch)
        for it, batch in enumerate(spanned(self.loader, "trainer.prep")):
            loss, acc = self.train_step(batch.seeds, batch.layers, batch.labels)
            self.step += 1
            meter.record(loss, acc, cfg.batch_size,
                         log_now=(it + 1) % cfg.log_every == 0)
        return meter.summary()

    def _grouped_batches(self):
        """Yield lists of S batches (cycling into the epoch start to fill
        the final ragged group, mirroring the loader's tail-wrap)."""
        S = self.cfg.steps_per_call
        group: List = []
        first: List = []
        for batch in self.loader:
            group.append(batch)
            if len(first) < S:
                first.append(batch)
            if len(group) == S:
                yield group
                group = []
        if group:
            i = 0
            while len(group) < S:
                group.append(first[i % len(first)])
                i += 1
            yield group

    def _train_epoch_grouped(self, epoch: int) -> Dict[str, float]:
        """``--mode mixed`` with ``steps_per_call`` S > 1 (JAX
        ``_train_epoch_multi``, ``trainer.py:923-967``): the loader's batches
        in groups of S (:meth:`_grouped_batches`), one step a batch, so that
        an epoch of nb batches is ceil(nb / S) * S steps; each group records
        its mean loss and accuracy, logged on JAX's cadence (its last group
        never, as JAX flushes it unlogged)."""
        cfg = self.cfg
        S = cfg.steps_per_call
        n_groups = -(-len(self.loader) // S)
        meter = _EpochMeter(self, epoch)
        for g, group in enumerate(spanned(self._grouped_batches(), "trainer.prep")):
            losses, accs = [], []
            for b in group:
                loss, acc = self.train_step(b.seeds, b.layers, b.labels)
                losses.append(loss)
                accs.append(acc)
            gi = self.step // S
            self.step += S
            meter.record(torch.stack(losses).mean(), torch.stack(accs).mean(), S * cfg.batch_size,
                         log_now=g < n_groups - 1 and (gi + 1) * S % cfg.log_every < S)
        return meter.summary()

    def _train_epoch_device(self, epoch: int) -> Dict[str, float]:
        """``--mode puregpu`` (JAX ``_train_epoch_device``,
        ``trainer.py:969-999``): the epoch's order of the train ids, cut into
        groups of ``steps_per_call * batch_size`` seeds (the ragged tail
        wrapped around the order), each group's seeds and labels copied to
        the device at once, then one :meth:`device_train_step` per batch of
        the group.  The seeds and labels are the JAX trainer's, step for
        step; each group logs its mean loss and accuracy on JAX's cadence."""
        cfg = self.cfg
        S, B = cfg.steps_per_call, cfg.batch_size
        self.sample_gen.manual_seed(cfg.seed + 2000 + epoch)
        with span("trainer.prep"):
            order = np.random.default_rng(cfg.seed + 31 * epoch).permutation(self.ds.train_idx)
        per_group = S * B
        n_groups = max(1, -(-len(order) // per_group))
        meter = _EpochMeter(self, epoch)
        for g in range(n_groups):
            with span("trainer.prep"):
                pick = _wrap_full(order[g * per_group:(g + 1) * per_group], order, per_group)
                packed = np.empty((S, 2, B), np.int32)
                packed[:, 0] = pick.reshape(S, B)
                packed[:, 1] = self.ds.labels[pick].reshape(S, B)
                packed = self._tensor(packed)  # the group's one host-to-device copy
                batches = [(packed[i, 0], packed[i, 1]) for i in range(S)]
            losses, accs = [], []
            for seeds, labels in batches:
                loss, acc = self.device_train_step(seeds, labels)
                losses.append(loss)
                accs.append(acc)
            self.step += S
            meter.record(torch.stack(losses).mean(), torch.stack(accs).mean(), per_group,
                         log_now=(g + 1) % max(1, cfg.log_every // S) == 0)
        return meter.summary()

    def _train_epoch_full_neighbor(self, epoch: int) -> Dict[str, float]:
        """``--full-neighbor`` (JAX ``_train_epoch_full_neighbor``): the
        epoch's order of the train ids, ``default_rng(seed + 31 * epoch)``,
        cut into ``max(1, len // batch_size)`` batches, each wrapped to full
        size around the order, one :meth:`full_neighbor_step` each, or
        :meth:`node_sharded_step` under ``--node-shard``."""
        cfg = self.cfg
        B = cfg.batch_size
        order = np.random.default_rng(cfg.seed + 31 * epoch).permutation(self.ds.train_idx)
        meter = _EpochMeter(self, epoch)
        for b in range(max(1, len(order) // B)):
            pick = _wrap_full(order[b * B:(b + 1) * B], order, B)
            if self.nshard is not None:
                loss, acc = self.node_sharded_step(pick)
            else:
                loss, acc = self.full_neighbor_step(self._tensor(pick.astype(np.int64)))
            self.step += 1
            meter.record(loss, acc, B, log_now=(b + 1) % cfg.log_every == 0)
        return meter.summary()

    # ------------------------------------------------------------------
    def _eval_labels(self):
        """The labels and the three splits on the device (moved once)."""
        if self._labels is None:
            ds = self.ds
            self._labels = tuple(self._tensor(a) for a in (
                ds.labels.astype(np.int64), ds.train_idx, ds.val_idx, ds.test_idx))
        return self._labels

    def _full_graph(self) -> FullGraph:
        """The COO graph and degrees on the device, moved once, with the
        row index that its first forward without gradient builds."""
        if self._graph is None:
            g = self.ds.graph
            src, dst = g.to_coo()
            self._graph = FullGraph(self._tensor(src.astype(np.int64)),
                                    self._tensor(dst.astype(np.int64)), g.num_nodes,
                                    self._tensor(g.degrees.astype(np.float32)),
                                    self.cfg.edge_chunk)
        return self._graph

    def _ensure_nshard_layout(self, n_ring: int) -> NodeSharding:
        """Build (once) the ragged node-sharded layout of the graph for a
        ring of ``n_ring`` shards and this rank's part of it on the device
        (JAX ``_ensure_nshard_layout``), shared by training and the sharded
        inference, so that the two can never disagree on it."""
        if self.nshard is not None:
            if self.nshard.layout.num_shards != n_ring:
                raise ValueError(
                    f"cached node-shard layout was built for "
                    f"{self.nshard.layout.num_shards} shards, requested {n_ring} — "
                    f"training placement and sharded inference must agree "
                    f"on the ring width")
            return self.nshard
        g = self.ds.graph
        t0 = time.perf_counter()
        src, dst = g.to_coo()
        lay = partition_edges_ragged(src.astype(np.int64), dst.astype(np.int64),
                                     g.num_nodes, n_ring)
        self.nshard_layout_s = time.perf_counter() - t0
        self.nshard = NodeSharding(self.node_mesh, lay, g.degrees, self.device,
                                   self.cfg.edge_chunk)
        return self.nshard

    def full_graph_spmm(self, route: str) -> "FullGraphSpmm":
        """The full-graph sum of ``route`` ("pallas" or "blocked"), its host
        tiling built on first use and kept on the device."""
        if route not in self._spmms:
            ds, n = self.ds, self.ds.num_nodes
            src, dst = ds.graph.to_coo()
            t0 = time.perf_counter()
            if route == "pallas":
                e_t = auto_tile_edges(len(src), n)
                # the reference's chunk size, ~1 GB of bf16 messages at the
                # widest feature dim (a tiling size: the kernel gathers none)
                width = max(ds.feat_dim, self.cfg.hidden_dim)
                tu = build_spmm_tiles_uniform(src.astype(np.int32), dst, n, tile_edges=e_t,
                                              tiles_per_chunk=max(256, (1 << 30) // (e_t * width * 2)))
                arrays = (tu.src, tu.dstl, tu.w, tu.blkl, tu.blk0)
                meta = (tu.num_blocks_padded, tu.blocks_per_chunk, tu.block_rows, e_t, n)
                info = dict(chunks=tu.blk0.shape[0], tiles=tu.blkl.size, slots=tu.src.size,
                            blocks=-(-n // tu.block_rows), tile_edges=e_t)
            elif route == "blocked":
                tile, ct = default_blocked_tiling(self.device)
                ts = build_window_tiles(src.astype(np.int64), dst.astype(np.int64), n,
                                        tile=tile, dst_buckets=16, chunk_tiles=ct)
                arrays = chunk_tiles_host(ts, ct)
                meta = (tile, n)
                info = dict(chunks=ts.win.shape[0] // ct, tiles=ts.win.shape[0],
                            slots=ts.idx.size, tile=tile)
            else:
                raise ValueError(f"no tiled SpMM for route {route!r}")
            self._spmms[route] = FullGraphSpmm(route, tuple(self._tensor(a) for a in arrays),
                                               meta, info, time.perf_counter() - t0)
        return self._spmms[route]

    @torch.no_grad()
    def evaluate_sampled(self, seed: int = 1234) -> Dict[str, float]:
        """Split accuracies by the sampled fan-out forward (``--eval-sampled``,
        JAX ``trainer.py:1161-1198``): each evaluated seed runs through the
        forward training uses, dropout off.  It approximates full-neighbour
        inference (the fan-out bounds each hop) and is the evaluation that
        fits one card where the layer-wise one must hold (N, D) activations.
        As in JAX: one ``default_rng(seed)`` draws, in this order, each split
        over ``eval_sample_max``'s subsample and then its blocks, sampled on
        the host even under ``--mode puregpu``; ``max(1, len // B)`` batches
        a split, the last wrapped to full size around it, each counted as
        ``B`` seeds.  One host sync a split."""
        cfg, B = self.cfg, self.cfg.batch_size
        rng = np.random.default_rng(seed)
        res = {}
        for name, idx in (("train", self.ds.train_idx), ("val", self.ds.val_idx),
                          ("test", self.ds.test_idx)):
            if len(idx) > cfg.eval_sample_max:
                idx = rng.choice(idx, cfg.eval_sample_max, replace=False)
            correct, total = [], 0
            for b in range(max(1, len(idx) // B)):
                pick = _wrap_full(idx[b * B:(b + 1) * B], idx, B)
                blk = sample_block(self.ds.graph, pick, cfg.fanouts, rng)
                logits = self.model(self._tensor(blk.seeds),
                                    [self._tensor(l) for l in blk.layers], train=False)
                labels = self._tensor(self.ds.labels[pick].astype(np.int64))
                correct.append((logits.argmax(-1) == labels).sum())
                total += B
            res[f"{name}_acc"] = int(torch.stack(correct).sum()) / max(total, 1)
        return res

    @torch.no_grad()
    def evaluate(self) -> Dict[str, float]:
        """Split accuracies by full-graph propagation over every edge through
        the ``--spmm`` route (on the CPU the kernels' plain versions); three
        scalars come back to the host.  ``--eval-sampled`` takes
        :meth:`evaluate_sampled` instead, and ``--node-shard`` over ranks
        :meth:`infer_full_sharded` (every rank of the group calls it)."""
        with span("trainer.eval"):
            if self.cfg.eval_sampled:
                return self.evaluate_sampled()
            if self.node_mesh is not None:
                return self._accuracies(self.infer_full_sharded())
            return self._accuracies(self._full_logits(self.cfg.spmm))

    def _accuracies(self, logits: torch.Tensor) -> Dict[str, float]:
        """The three splits' accuracies of every node's ``logits``."""
        with span("trainer.accuracies"):
            labels, *splits = self._eval_labels()
            pred = logits.argmax(-1)
            accs = torch.stack([(pred[i] == labels[i]).float().mean() for i in splits])
            count("trainer.host_reads")
            return dict(zip(EVAL_KEYS, accs.tolist()))

    @torch.no_grad()
    def infer_full(self) -> torch.Tensor:
        """Layer-wise full-neighbour inference over all nodes: the logits
        that :meth:`evaluate` scores, through the blocked kernel under
        ``--spmm blocked`` and the ``xla`` route otherwise (as the
        reference), or under ``--node-shard`` over ranks
        :meth:`infer_full_sharded`.  Returns the (N, num_classes) logits on
        the device."""
        if self.node_mesh is not None:
            return self.infer_full_sharded()
        return self._full_logits("blocked" if self.cfg.spmm == "blocked" else "xla")

    @torch.no_grad()
    def infer_full_sharded(self) -> torch.Tensor:
        """Node-sharded layer-wise inference (JAX ``infer_full_sharded``,
        ``trainer.py:1121-1159``): this rank's rows' features materialised
        ``inference_chunk`` rows at a time, every layer over the ring, then
        every rank's rows gathered over the node axis: the (N, num_classes)
        logits in node order, on the device of every rank.  Every rank of
        the group calls it."""
        ns = self._ensure_nshard_layout(self.node_mesh.n_node)
        ids, step = ns.node_ids, self.cfg.inference_chunk
        h = torch.cat([self.model.materialize_features(ids[s:s + step])
                       for s in range(0, ids.shape[0], step)])
        return ns.gather_rows(ns.propagate(h, self.model.apply_conv, self.cfg.num_layers))

    def _full_logits(self, route: str) -> torch.Tensor:
        """Every node's logits by full-graph propagation through ``route``:
        ``xla`` is the model's full-graph forward over the graph's row
        index, built once a trainer before the layers' spans; ``pallas`` and
        ``blocked`` aggregate each layer through their tiled SpMM and take
        the model's ``apply_conv``."""
        graph = self._full_graph()
        if route == "xla":
            graph.index()
            return self.model.forward_full_graph(graph)
        spmm = self.full_graph_spmm(route)
        degc = torch.clamp(graph.deg, min=1.0)[:, None]
        h = self.model.materialize_features(torch.arange(
            self.ds.num_nodes, dtype=torch.int32, device=self.device))
        for li in range(self.cfg.num_layers):
            with span("spmm.aggregate"):
                agg = spmm(h) / degc
            h = self.model.apply_conv(h, agg, li)
        return h

    def maybe_populate_cache(self) -> None:
        """After the warmup epoch: cache the K most accessed ids' rows
        (``sage_dgl_partition.py:350-361``), from the host loader's counts in
        ``--mode mixed`` and the step's in ``--mode puregpu`` (whose loader
        never ran; its zero counts would populate an empty cache), then
        reset the cache group's optimizer state: slots now hold other ids."""
        cfg = self.cfg
        if not (cfg.use_tt and cfg.cache_size > 0):
            return
        freq = self.loader.freq
        if cfg.mode == "puregpu" or (freq is not None and not freq.any()):
            freq = None
        # JAX's cache_populate_apply: the rows and the id table, in place
        self.model.embed.cache_populate(freq)
        reset_cache_opt_state(self.cache_opt)

    def access_count_stats(self) -> Optional[Dict[str, Any]]:
        """Per-row access counts and their skew (JAX ``trainer.py:1370-1386``):
        the model's counts under ``--access-counts`` without TT, else the
        host loader's (``--access-counts`` or the cache), else None."""
        if isinstance(self.model.embed, AccessCountingEmbedding):
            counts = self.model.embed.counts.cpu().numpy()
        elif self.loader.freq is not None:
            counts = self.loader.freq
        else:
            return None
        return {"counts": counts, "percentages": access_percentages(counts)}

    # ------------------------------------------------------------------
    def checkpoint_state(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """(variables, opt_state) as :func:`save_checkpoint` takes them: the
        model's ``state_dict`` and what carries across epochs (the SR store's
        generator, the host loader's generator and counts), then every
        optimizer's state.  Tensors are the trainer's own, not copies."""
        bg = self.loader.rng.bit_generator
        loader = {"bit_generator": bg.state,
                  "children_spawned": bg.seed_seq.n_children_spawned}
        if self.loader.freq is not None:
            loader["freq"] = torch.from_numpy(self.loader.freq)
        variables = {"model": self.model.state_dict(),
                     "sr_gen": self.sr_gen.get_state(), "loader": loader}
        opt_state = {"adam": vars(self.opt_state),
                     "tt_opt": None if self.tt_opt is None else vars(self.tt_opt),
                     "tt_acc": self.tt_acc,
                     "cache_acc": None if self.cache_opt is None else self.cache_opt.acc,
                     "plateau": vars(self.plateau)}
        return variables, opt_state

    def save(self, ckpt_dir: str, extra: Optional[Dict[str, Any]] = None) -> str:
        """Write the full training state to ``ckpt_dir/step_{step}.pt``."""
        return save_checkpoint(ckpt_dir, self.step, *self.checkpoint_state(),
                               extra={"step": self.step, **(extra or {})})

    @torch.no_grad()
    def restore(self, path: Optional[str] = None, ckpt_dir: Optional[str] = None) -> None:
        """Restore the state :meth:`save` wrote (the latest checkpoint of
        ``ckpt_dir``, default ``./checkpoints``, without ``path``), copying
        each tensor into the trainer's own."""
        if path is None:
            path = latest_checkpoint(ckpt_dir or "./checkpoints")
            if path is None:
                raise FileNotFoundError("no checkpoint found")
        variables, opt_state = self.checkpoint_state()
        state = restore_checkpoint(path, {"variables": variables, "opt_state": opt_state})
        saved_vars, saved_opt = state["variables"], state["opt_state"]
        self.model.load_state_dict(saved_vars["model"], strict=True)
        self.sr_gen.set_state(saved_vars["sr_gen"])
        loader = saved_vars["loader"]
        seq = self.loader.rng.bit_generator.seed_seq
        bg = type(self.loader.rng.bit_generator)(np.random.SeedSequence(
            seq.entropy, spawn_key=seq.spawn_key, pool_size=seq.pool_size,
            n_children_spawned=loader["children_spawned"]))
        bg.state = loader["bit_generator"]
        self.loader.rng = np.random.Generator(bg)
        if self.loader.freq is not None:
            self.loader.freq[:] = loader["freq"].numpy()

        def copy(dst, src):
            if (dst is None) != (src is None):
                raise ValueError(f"checkpoint {path} holds another optimizer configuration")
            if isinstance(dst, torch.Tensor):
                dst.copy_(src)
            elif isinstance(dst, (list, tuple)):
                for d, s_ in zip(dst, src, strict=True):
                    copy(d, s_)
            elif isinstance(dst, dict):
                for k in dst:
                    copy(dst[k], src[k])

        copy(opt_state, saved_opt)
        self.step = int(state["extra"].get("step", 0))

    def fit(self, epochs: Optional[int] = None) -> Dict[str, Any]:
        cfg = self.cfg
        epochs = epochs or cfg.epochs
        best = {"val_acc": 0.0, "test_acc": 0.0}
        history = []
        for epoch in range(epochs):
            stats = self.train_epoch(epoch)
            if epoch == 0:
                self.maybe_populate_cache()
            if not cfg.skip_eval and (
                    (epoch + 1) % cfg.eval_every == 0 or epoch == epochs - 1):
                # --dist: rank 0 evaluates, every rank gets its accuracies;
                # the node-sharded evaluate is every rank's
                every = self.dp is None or (self.node_mesh is not None
                                            and not cfg.eval_sampled)
                stats.update(self.evaluate() if every
                             else self.dp.from_rank0(self.evaluate, EVAL_KEYS))
                if stats["val_acc"] >= best["val_acc"]:
                    best = {"val_acc": stats["val_acc"],
                            "test_acc": stats["test_acc"], "epoch": epoch}
            history.append(stats)
            if self.logger:
                self.logger.info(f"epoch {epoch}: {stats}")
        return {"history": history, "best": best, "metrics": self._metrics}
