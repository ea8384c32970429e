"""One run of one cell: set-up, the measured window, the traced slice, and
the comparison with the plain reference.

Everything that belongs to one configuration, one traffic mix or one
metric is a file the harness finds by name:

* ``BENCHMARK.json`` names each cell's configuration and traffic mix, and
  lists the metrics;
* ``gnnbench/configs/<config>.json``: the graph, the model, the trainer
  and the precision the configuration states, and its ``reference``: the
  file of its architecture's plain reference, which also gives all that
  the harness knows of the model (``INTERFACE``);
* ``gnnbench/traffic/<traffic>.json``: the drive (``train_epochs`` or
  ``evaluate_calls``), its warm-up and its overrides of the trainer;
* ``gnnbench/end_to_end/<metric>.py`` and ``gnnbench/metrics/<metric>.py``:
  each metric's reader (``read(ctx)``, None where it finds nothing), and
  for a per-layer metric the span it opens (``install(trainer, ctx)``).
  A metric split by the end-to-end metric it moves (``<name>.<part>``)
  reads by the file of the longest dotted prefix of its name that has one;
* ``gnnbench/limits/<workload>.json``: the limit of each number compared.

The program, ``falcon_ttdforgnns_torch``, is imported only as the system
under test.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import check
from .graph import Graph, edge_keys, load_graph
from .profiling import Slice, complete_slice

PKG = Path(__file__).resolve().parent  # the readers: code, beside this file
FORBIDDEN = ("jax", "jaxlib", "flax", "falcon_ttdforgnns_tpu")
CHECK_STEPS = 3  # the first steps the reference repeats
# what a configuration's reference module gives (gnnbench/README.md)
INTERFACE = ("ARCH", "param_shapes", "make_weights", "train_readings", "full_graph_logits",
             "level_ids", "CONTROLS", "ADAM_B1", "DROPOUT_SITES", "mask_shapes",
             "tower_train_flops", "tower_eval_flops")


class CellError(RuntimeError):
    """A run that cannot give a result."""


# ------------------------------------------------------------------ files
def _load_module(path: Path):
    """The module of a file under ``gnnbench/``, named by its path there
    and entered in ``sys.modules`` (a dataclass looks its module up)."""
    rel = path.resolve().relative_to(PKG).with_suffix("")
    name = "gnnbench_" + "_".join(rel.parts).replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def reader_path(kind: str, name: str) -> Path:
    """``<kind>/<name>.py`` beside this file, or the file of the longest
    dotted prefix of ``name`` that has one: ``device_idle_share.eval``
    reads by ``device_idle_share.py``."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        path = PKG / kind / (".".join(parts[:n]) + ".py")
        if path.is_file():
            return path
    raise CellError(f"no reader {kind}/{name}.py, nor one of a dotted prefix of it")


def load_reference(config: dict):
    """The module of the configuration's architecture: the file its
    ``reference`` names, resolved against the checkout that holds this
    file and lying under ``gnnbench/``, whose ``ARCH`` is the
    configuration's ``model.arch`` and which has every name of
    ``INTERFACE``."""
    name = config.get("reference")
    if not name:
        raise CellError(f"the configuration {config.get('name')!r} names no reference")
    path = (PKG.parent / name).resolve()
    if not path.is_relative_to(PKG):
        raise CellError(f"the reference {name} lies outside {PKG.name}/")
    if not path.is_file():
        raise CellError(f"no reference file {name}")
    ref = _load_module(path)
    missing = [n for n in INTERFACE if not hasattr(ref, n)]
    if missing:
        raise CellError(f"the reference {name} lacks {missing}")
    arch = config["model"].get("arch")
    if ref.ARCH != arch:
        raise CellError(f"the reference {name} is of {ref.ARCH!r}, the configuration's "
                        f"model of {arch!r}")
    return ref


def load_cell(root: Path, workload: str) -> SimpleNamespace:
    """The cell's entries and data files under ``root``, its
    configuration's reference module, and its metrics' readers beside this
    file, by the names ``BENCHMARK.json`` and the configuration give."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise CellError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    ref = load_reference(config)
    traffic = json.loads((root / "gnnbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((root / "gnnbench" / "limits" / f"{workload}.json").read_text())

    def mine(m):
        return workload in m.get("workloads", [workload])

    return SimpleNamespace(
        name=workload, cell=cell, config=config, ref=ref, traffic=traffic, limits=limits,
        end_to_end=[(m, _load_module(reader_path("end_to_end", m["name"])))
                    for m in bench["end_to_end"] if mine(m)],
        per_layer=[(m, _load_module(reader_path("metrics", m["name"])))
                   for m in bench["per_layer"] if mine(m)])


def process_age_s() -> float:
    """Seconds since this process started (``/proc``)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------- the program
def dataset_of(g: Graph, name: str):
    from falcon_ttdforgnns_torch.graph.csr import CSRGraph, NodeDataset
    return NodeDataset(graph=CSRGraph(indptr=g.indptr, indices=g.indices, num_nodes=g.num_nodes),
                       labels=g.labels, train_idx=g.train_idx, val_idx=g.val_idx,
                       test_idx=g.test_idx, num_classes=g.num_classes, feat_dim=g.feat_dim,
                       name=name)


def train_config(config: dict, traffic: dict, seed: int):
    """The program's TrainConfig as the configuration states it, with the
    traffic mix's overrides and the run's seed."""
    from falcon_ttdforgnns_torch.train.trainer import TrainConfig
    model, tt = config["model"], config.get("tt")
    kw = dict(batch_size=model["batch_size"], fanouts=tuple(model["fanouts"]),
              dropout=model["dropout"], hidden_dim=model["hidden_dim"],
              num_layers=model["num_layers"], use_tt=tt is not None)
    if tt is not None:
        kw.update(tt_ranks=tuple(tt["ranks"]), p_shapes=tuple(tt["p_shapes"]),
                  q_shapes=tuple(tt["q_shapes"]))
    kw.update(config["trainer"])
    kw.update(traffic.get("overrides", {}))
    return TrainConfig(**kw, seed=int(seed))


def build_trainer(ds, config: dict, traffic: dict, seed: int, weights, device):
    """The program's trainer, its parameters set to the run's weights."""
    from falcon_ttdforgnns_torch.train.trainer import SageTrainer
    trainer = SageTrainer(ds, train_config(config, traffic, seed), device=str(device))
    params = dict(trainer.model.named_parameters())
    if sorted(params) != sorted(weights):
        raise CellError(f"the program's parameters {sorted(params)} are not the "
                        f"configuration's {sorted(weights)}")
    with torch.no_grad():
        for n, w in weights.items():
            params[n].copy_(w)
    return trainer


def adam_moments(trainer) -> Dict[str, torch.Tensor]:
    """Adam's first moment of every parameter, by name, from the trainer's
    optimizer states (the dense group, and the fused cores' own)."""
    by_id = {id(p): m for p, m in zip(trainer.opt_params, trainer.opt_state.m)}
    if getattr(trainer, "tt_opt", None) is not None:
        by_id.update({id(p): m for p, m in zip(trainer.cores, trainer.tt_opt.m)})
    out = {}
    for n, p in trainer.model.named_parameters():
        if id(p) not in by_id:
            raise CellError(f"no Adam state found for {n}")
        out[n] = by_id[id(p)]
    return out


def reset_state(trainer, weights) -> None:
    """The trainer's state as set-up built it, in place: the run's weights,
    Adam's moments and counts (the dense group's and the fused cores') at
    zero, the plateau's state new and the step count 0.  Its generators
    are reseeded by ``train_epoch`` itself."""
    params = dict(trainer.model.named_parameters())
    with torch.no_grad():
        for n, w in weights.items():
            params[n].copy_(w)
        for st in (trainer.opt_state, getattr(trainer, "tt_opt", None)):
            if st is not None:
                for t in (*st.m, *st.v, st.count):
                    t.zero_()
        pl = trainer.plateau
        pl.scale.fill_(1.0)
        pl.best_value.fill_(math.inf)
        pl.plateau_count.zero_()
        pl.ema.fill_(math.inf)
    if any(True for _ in trainer.model.buffers()):
        raise CellError("the model holds buffers that reset_state does not know")
    trainer.step = 0


class _Recorded(Exception):
    """Raised after the last recorded step, to end the recorded epoch."""


class StepRecorder:
    """Records the program's first steps through the window's own call,
    ``--mode puregpu``'s ``device_train_step``: each step's seeds, sampled
    tree, labels, dropout masks (the ``dropout`` of each of the reference's
    ``DROPOUT_SITES``) and loss; after the first step the gradient norms
    Adam's moments give; after the last the norm of each parameter's change
    from the run's weights, and then it ends the epoch."""

    def __init__(self, trainer, weights, n_steps: int, ref):
        self.trainer, self.weights, self.n, self.ref = trainer, weights, n_steps, ref
        self.steps: List[dict] = []
        self.grads = self.grad_norms = self.change_norms = None
        self._cur: Optional[dict] = None
        if trainer.cfg.mode != "puregpu":
            raise CellError(f"the recorder follows --mode puregpu's step, not {trainer.cfg.mode}")
        self._sites = [(mod, mod.dropout) for mod in
                       map(importlib.import_module, dict.fromkeys(ref.DROPOUT_SITES))]
        for mod, inner in self._sites:
            mod.dropout = self._recording(inner)
        self._inner_sample, self._inner_step = trainer.sample_layers, trainer.device_train_step
        trainer.sample_layers, trainer.device_train_step = self._sample, self._device_step

    def remove(self) -> None:
        for mod, inner in self._sites:
            mod.dropout = inner
        for name in ("sample_layers", "device_train_step"):
            self.trainer.__dict__.pop(name, None)

    def _recording(self, inner):
        def drop(h, p, train, generator):
            out = inner(h, p, train, generator)
            if self._cur is not None and train and p > 0:
                self._cur["masks"].append((out != 0).cpu())
            return out
        return drop

    def _sample(self, seeds):
        layers = self._inner_sample(seeds)
        if self._cur is not None:
            self._cur["layers"] = [l.cpu() for l in layers]
        return layers

    def _begin(self) -> bool:
        if len(self.steps) < self.n:
            self._cur = {"masks": []}
            return True
        return False

    def _end(self, seeds, labels, loss) -> None:
        cur, self._cur = self._cur, None
        cur.update(seeds=torch.as_tensor(seeds).cpu(), labels=torch.as_tensor(labels).cpu(),
                   loss=float(loss))
        self.steps.append(cur)
        if len(self.steps) == 1:  # Adam's first moment after one step is (1 - b1) g
            grads = {n: m.detach() / (1.0 - self.ref.ADAM_B1)
                     for n, m in adam_moments(self.trainer).items()}
            self.grad_norms = {n: float(g.norm()) for n, g in grads.items()}
            self.grads = {n: g.to("cpu") for n, g in grads.items()}
        if len(self.steps) == self.n:
            params = dict(self.trainer.model.named_parameters())
            self.change_norms = {n: float((params[n].detach() - w).norm())
                                 for n, w in self.weights.items()}

    def _device_step(self, seeds, labels):
        rec = self._begin()
        loss, acc = self._inner_step(seeds, labels)
        if rec:
            self._end(seeds, labels, loss)
            if len(self.steps) == self.n:
                raise _Recorded
        return loss, acc

    def readings(self) -> dict:
        if len(self.steps) < self.n:
            raise CellError(f"the program ran {len(self.steps)} steps, {self.n} are checked")
        return {"losses": [s["loss"] for s in self.steps], "grads": self.grads,
                "grad_norms": self.grad_norms, "change_norms": self.change_norms}


def steps_on(steps: List[dict], device) -> List[dict]:
    return [{"seeds": s["seeds"].to(device), "labels": s["labels"].to(device),
             "layers": [l.to(device) for l in s["layers"]],
             "masks": [m.to(device) for m in s["masks"]]} for s in steps]


def free_device(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


# ------------------------------------------------------------- the drives
class TrainDrive:
    """Whole ``train_epoch`` calls back to back.  Set-up runs epoch 0; the
    window runs epochs 1, 2, ... until ``seconds`` have passed and ends
    with a synchronise after the last one.  A unit of work is an epoch:
    every labelled train seed once.  After the window the same trainer is
    reset to the run's weights and fresh optimizer state, and the first
    steps of epoch 0 are recorded through the call the window ran; the
    reference repeats them."""

    kind = "train"

    def __init__(self, ctx):
        self.ctx = ctx

    def setup(self, trainer, weights) -> None:
        self.epoch = self.ctx.traffic.get("warmup_epochs", 1)
        for e in range(self.epoch):
            trainer.train_epoch(e)

    def record(self, trainer, device) -> None:
        c = self.ctx
        g = c.graph
        weights = c.ref.make_weights(c.config, g.num_nodes, g.num_classes, c.seed, device)
        reset_state(trainer, weights)
        rec = StepRecorder(trainer, weights, CHECK_STEPS, c.ref)
        try:
            trainer.train_epoch(0)
        except _Recorded:
            pass
        finally:
            rec.remove()
        c.steps, c.prog = rec.steps, rec.readings()

    def unit(self, trainer) -> bool:
        stats = trainer.train_epoch(self.epoch)
        self.epoch += 1
        return math.isfinite(stats["loss"])

    def done(self) -> bool:
        return time.perf_counter() >= self.ctx.deadline

    def work(self, units: int) -> dict:
        n_train = self.ctx.graph.train_idx.shape[0]
        return {"labelled_seeds": units * n_train}

    def check(self, device, control: Optional[str] = None) -> Dict[str, float]:
        c = self.ctx
        g, ref = c.graph, c.ref
        dev = torch.device(device)
        keys = torch.as_tensor(edge_keys(g), device=dev)
        deg = torch.as_tensor(np.diff(g.indptr), device=dev)
        train_mask = torch.zeros(g.num_nodes, dtype=torch.bool, device=dev)
        train_mask[torch.as_tensor(g.train_idx, device=dev)] = True
        labels = torch.as_tensor(g.labels, device=dev)
        steps = steps_on(c.steps, dev)
        model = c.config["model"]
        bad = check.tree_faults(keys, deg, g.num_nodes, model["fanouts"], steps,
                                train_mask, labels)
        bad += check.mask_faults(ref.mask_shapes, model, steps)
        del keys, train_mask
        if bad:  # the reference cannot follow draws of the wrong shape
            return {"tree_faults": float(bad)}
        for st in steps:  # the reference takes the labels of its own graph
            st["labels"] = labels[st["seeds"].long()]
        weights = ref.make_weights(c.config, g.num_nodes, g.num_classes, c.seed, dev)
        r = ref.train_readings(c.config, weights, steps)
        prog = c.prog if control is None else ref.train_readings(c.config, weights, steps,
                                                                 ref.CONTROLS[control])
        nums = check.train_numbers(prog, r)
        nums["tree_faults"] = float(bad)
        c.detail = check.leaf_gaps(prog, r)
        return nums

    def trace_slice(self, trainer) -> Callable[[], object]:
        def run():
            self.unit(trainer)
        return run


class EvalDrive:
    """``evaluate()`` back to back.  Before each call the harness adds
    seeded noise to the TT cores in place, so that no call can reuse the
    last one's result.  Set-up runs one call; the window's calls are
    checked at one call drawn from the seed among its first few, and at
    its last."""

    kind = "eval"

    def __init__(self, ctx):
        self.ctx = ctx

    def _noise(self, trainer) -> None:
        with torch.no_grad():
            for n, p in trainer.model.named_parameters():
                if n.startswith("embed.tt_core_"):
                    p.add_(torch.randn(p.shape, generator=self.gen, device=p.device),
                           alpha=self.noise_std)

    def setup(self, trainer, weights) -> None:
        c = self.ctx
        t = c.traffic
        self.noise_std = t["noise_std"]
        self.gen = torch.Generator(device=trainer.device)
        self.gen.manual_seed(int(c.seed) + t["noise_seed_offset"])
        lo, hi = t["checked_call_range"]
        self.checked = {int(np.random.default_rng(c.seed).integers(lo, hi + 1))}
        self.calls, self.got, self.last = 0, {}, False
        inner = trainer._accuracies

        def capture(logits):
            accs = inner(logits)
            if self.calls in self.checked or self.last:
                self.got[self.calls] = (logits.detach().to("cpu"), list(accs.values()))
            return accs

        trainer._accuracies = capture
        for _ in range(t.get("warmup_calls", 1)):
            self._noise(trainer)
            trainer.evaluate()
            self.calls += 1
        self.got.clear()

    def record(self, trainer, device) -> None:
        """The window's calls were captured as they ran."""

    def unit(self, trainer) -> bool:
        self._noise(trainer)
        self.last = time.perf_counter() >= self.ctx.deadline
        accs = trainer.evaluate()
        self.calls += 1
        return all(0.0 <= a <= 1.0 for a in accs.values())

    def done(self) -> bool:
        if self.last:
            self.window_end = self.calls
        return self.last

    def work(self, units: int) -> dict:
        return {"calls": units}

    def check(self, device, control: Optional[str] = None) -> Dict[str, float]:
        c, g, ref = self.ctx, self.ctx.graph, self.ctx.ref
        dev = torch.device(device)
        # the drawn call is due only if the window reached it
        want = sorted({k for k in self.checked if k < self.window_end} | {self.window_end - 1})
        missing = set(want) - set(self.got)
        if missing:
            return {"missing_calls": float(len(missing))}
        weights = ref.make_weights(c.config, g.num_nodes, g.num_classes, c.seed, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(c.seed) + c.traffic["noise_seed_offset"])
        cores = sorted(n for n in weights if n.startswith("embed.tt_core_"))
        indptr = torch.as_tensor(g.indptr, device=dev)
        indices = torch.as_tensor(g.indices, device=dev)
        labels = torch.as_tensor(g.labels.astype(np.int64), device=dev)
        splits = [torch.as_tensor(s, device=dev) for s in (g.train_idx, g.val_idx, g.test_idx)]
        worst: Dict[str, float] = {}
        for call in range(want[-1] + 1):
            for n in cores:  # the same draws, in the same order, as the run's
                weights[n].add_(torch.randn(weights[n].shape, generator=gen, device=dev),
                                alpha=self.noise_std)
            if call in self.got:
                logits, accs = self.got[call]
                r = ref.full_graph_logits(c.config, weights, indptr, indices)
                if control is not None:
                    logits = ref.full_graph_logits(c.config, weights, indptr, indices,
                                                   ref.CONTROLS[control])
                    accs = check.accuracies(logits, labels, splits)
                nums = check.eval_numbers(logits.to(dev), accs, r, labels, splits)
                del r
                for k, v in nums.items():
                    worst[k] = max(worst.get(k, 0.0), v)
        worst["missing_calls"] = 0.0
        return worst

    def trace_slice(self, trainer) -> Callable[[], object]:
        self.last = False

        def run():
            self._noise(trainer)
            trainer.evaluate()
        return run


DRIVES = {"train_epochs": TrainDrive, "evaluate_calls": EvalDrive}


# -------------------------------------------------------------- one run
def _complete(sl: Slice) -> bool:
    """Every kernel the host launched has a device record."""
    launches = sum(1 for n, _, _ in sl.host if "LaunchKernel" in n)
    kernels = sum(1 for n, _, _ in sl.device if not n.startswith(("Memcpy", "Memset")))
    return kernels > 0 and kernels >= launches


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", fault: Optional[str] = None, control: Optional[str] = None,
             numbers: bool = False) -> dict:
    """One run: returns the result line's fields, ``checks`` last.  With
    ``fault`` one of ``faults.FAULTS`` is planted in the program; with
    ``control`` the numbers compared are those of the reference in that
    precision (its ``CONTROLS``) put in the program's place.
    With ``numbers`` the result also holds every number the comparison
    read, compared or not, and each leaf's gaps (``gnnbench/readings.py``)."""
    import falcon_ttdforgnns_torch.train.trainer  # noqa: F401  the system under test, or fail now
    cell = load_cell(root, workload)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ctx = SimpleNamespace(seed=int(seed), config=cell.config, ref=cell.ref,
                          traffic=cell.traffic, deadline=float("inf"))
    g = load_graph(cell.config["graph"], root / "gnnbench" / "cache")
    ctx.graph = g
    ds = dataset_of(g, cell.config["name"])
    drive = DRIVES[cell.traffic["drive"]](ctx)
    weights = cell.ref.make_weights(cell.config, g.num_nodes, g.num_classes, seed, dev)
    trainer = build_trainer(ds, cell.config, cell.traffic, seed, weights, dev)
    if fault is not None:
        from . import faults
        faults.install(trainer, fault)
    drive.setup(trainer, weights)
    del weights
    free_device(dev)

    # a traced run opens its metrics' spans before the window, so that a
    # host-side reading comes from the untraced window
    tctx = SimpleNamespace(config=cell.config, ref=cell.ref, graph=g, kind=drive.kind,
                           device=dev, steps=0, step_ids=[], slice=None)
    undo = [mod.install(trainer, tctx) for _, mod in cell.per_layer
            if trace and hasattr(mod, "install")]

    # the measured window
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    setup_s = process_age_s()
    t0 = time.perf_counter()
    ctx.deadline = t0 + seconds
    units = failed = 0
    while True:
        units += 1
        failed += 0 if drive.unit(trainer) else 1
        if drive.done():
            break
    sync(dev)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    win = SimpleNamespace(kind=drive.kind, window_s=window_s, units=units, setup_s=setup_s,
                          peak_bytes=peak, **drive.work(units))

    metrics, breakdown, device_info = {}, None, {}
    if not trace:
        for m, mod in cell.end_to_end:
            v = mod.read(win)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        tctx.win = win
        undo.append(_count_steps(trainer, tctx))
        fn = drive.trace_slice(trainer)

        def attempt():
            tctx.steps = 0
            tctx.step_ids.clear()
            fn()

        tctx.slice = complete_slice(attempt, _complete) if dev.type == "cuda" else None
        for u in reversed(undo):
            u()
        sl = tctx.slice
        if sl is not None:
            device_info = {"busy_s": sl.busy_us() / 1e6, "window_s": sl.wall_s}
            breakdown = {"device_ops": [[n, s] for n, s in sl.by_name()[:10]],
                         "idle_gaps": [[n, s] for n, s in sl.idle_gaps(10)]}
        for m, mod in cell.per_layer:
            v = mod.read(tctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    drive.record(trainer, dev)
    del trainer
    free_device(dev)
    nums = drive.check(dev, control)
    # a number the comparison could not read counts as failed
    checks = {k: {"value": nums.get(k, math.inf), "limit": lim} for k, lim in cell.limits.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values()) and failed == 0
    device_fields = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                     "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
                     "count": 1, "memory_peak_bytes": int(peak), **device_info}
    out = {"correct": bool(correct), "attempted": units, "failed": failed,
           "metrics": metrics, "device": device_fields}
    if breakdown is not None:
        out["breakdown"] = breakdown
    if numbers:
        out["numbers"] = nums
        out["leaves"] = getattr(ctx, "detail", None)
    out["checks"] = checks
    return out


def _count_steps(trainer, tctx) -> Callable[[], None]:
    """Count the program's steps and keep the ids of the first few (the
    kernels' work is counted from them) while the slice is profiled."""
    inner = trainer._step

    def step(seeds, layers, labels):
        tctx.steps += 1
        if len(tctx.step_ids) < 4:
            tctx.step_ids.append(tctx.ref.level_ids(seeds, layers).to(torch.int32))
        return inner(seeds, layers, labels)

    trainer._step = step
    return lambda: trainer.__dict__.pop("_step", None)


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that the run may not load."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))
