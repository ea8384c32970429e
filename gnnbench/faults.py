"""Faults planted under the timed path, so that the comparison can be seen
to fail: the readings at a cell's size (``gnnbench/readings.py``) and the
CPU tests drive a run with one of these installed.

* ``unchanged``: a train step returns its state unchanged; an evaluation
  ignores the cores' changes since its first call;
* ``half_batch``: a train step's loss leaves out half of its batch and
  takes the mean over the rest; an evaluation leaves out half of the nodes' logits;
* ``altered``: the answer is altered where it is produced: the tower's
  logits scaled by 1.1 in training, one node's logits shifted by 10 in
  an evaluation.
"""

from __future__ import annotations

import torch

FAULTS = ("unchanged", "half_batch", "altered")


def install(trainer, fault: str) -> None:
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; expected one of {FAULTS}")
    model = trainer.model
    params = [p for _, p in model.named_parameters()]
    if fault == "unchanged":
        step, embed_fwd = trainer._step, model.embed.forward
        frozen = {}

        def unchanged_step(seeds, layers, labels):
            keep = [p.detach().clone() for p in params]
            out = step(seeds, layers, labels)
            with torch.no_grad():
                for p, k in zip(params, keep):
                    p.copy_(k)
            return out

        def stale_embed(*args, **kw):
            cores = [p for n, p in model.embed.named_parameters()]
            if not frozen:
                frozen.update({id(p): p.detach().clone() for p in cores})
            now = [p.detach().clone() for p in cores]
            with torch.no_grad():
                for p in cores:
                    p.copy_(frozen[id(p)])
            try:
                return embed_fwd(*args, **kw)
            finally:
                with torch.no_grad():
                    for p, k in zip(cores, now):
                        p.copy_(k)

        trainer._step = unchanged_step
        model.embed.forward = stale_embed
    elif fault == "half_batch":
        import falcon_ttdforgnns_torch.train.trainer as trainer_mod
        step, full = trainer._step, model.forward_full_graph

        class HalfLoss:
            """torch.nn.functional, its cross-entropy over the batch's
            first half."""

            def __getattr__(self, name):
                return getattr(torch.nn.functional, name)

            @staticmethod
            def cross_entropy(logits, labels, *args, **kw):
                h = logits.shape[0] // 2
                return torch.nn.functional.cross_entropy(logits[:h], labels[:h], *args, **kw)

        def half_step(*args):
            was, trainer_mod.F = trainer_mod.F, HalfLoss()
            try:
                return step(*args)
            finally:
                trainer_mod.F = was

        def half_nodes(*args, **kw):
            out = full(*args, **kw)
            out[out.shape[0] // 2:] = 0
            return out

        trainer._step = half_step
        model.forward_full_graph = half_nodes
    else:
        tower, full = model._conv_tower, model.forward_full_graph

        def scaled(*args, **kw):
            return tower(*args, **kw) * 1.1

        def shifted(*args, **kw):
            out = full(*args, **kw)
            out[0, 0] += 10
            return out

        model._conv_tower = scaled
        model.forward_full_graph = shifted
