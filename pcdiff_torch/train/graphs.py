"""The train step's loss, backward and gradient norm as CUDA graphs, replayed step after step.

A small model's step is paced by the host: thousands of launches, each costing the host
more than the card takes to run it. :class:`StepGraphs` captures the part of the step
between the draws and the optimizer (zeroing the gradients, the loss with its dropout
draws, ``backward`` and the gradients' global norm) once for each variant of the step
(the self-conditioning coin, the chamfer term, the batch's shapes) and replays it: the
host then enqueues one graph where it enqueued every launch.

What it computes is the eager step's, launch for launch:

- the first step of each variant runs eagerly (on the graphs' side stream, which also warms
  up the libraries and the kernels before any capture); the next captures and replays;
- the gradients live in one static buffer a parameter, zeroed in the graph and filled by
  ``backward`` (0 + g is g), and stay the parameters' ``.grad`` for the optimizer, which
  runs eagerly as before;
- the generator is registered with every graph, so a replay draws the dropout masks from
  the generator's current offset and advances it as the eager step would;
- the chamfer flag enters as a device scalar 1.0 (the eager step's ``True`` becomes the
  same 1.0 gate), so that no host value is copied inside a capture;
- the kernel wrappers' launch counters count a replay's launches: a capture's calls are
  taken back and every replay adds them again.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch

from .state import global_norm

__all__ = ["StepGraphs"]


def _counter_modules():
    from ..ops import attn_ladder, flash_attention, layer_norm, ln_dense, ln_mlp

    return ((flash_attention, ("launches", "bwd_launches", "k7_launches")),
            (ln_dense, ("launches", "bwd_launches", "width_launches")),
            (ln_mlp, ("launches", "width_launches")),
            (layer_norm, ("launches", "bwd_launches")),
            (attn_ladder, ("launches",)))


def _read_counters() -> Dict[Tuple[str, str], Any]:
    return {(m.__name__, a): (dict(getattr(m, a)) if isinstance(getattr(m, a), dict)
                              else getattr(m, a))
            for m, attrs in _counter_modules() for a in attrs}


def _add_counters(delta: Dict[Tuple[str, str], Any], sign: int = 1) -> None:
    for m, attrs in _counter_modules():
        for a in attrs:
            d = delta[(m.__name__, a)]
            if isinstance(d, dict):
                counts = getattr(m, a)
                for k, v in d.items():
                    counts[k] = counts.get(k, 0) + sign * v
                    if counts[k] == 0:
                        del counts[k]
            else:
                setattr(m, a, getattr(m, a) + sign * d)


def _diff_counters(after, before) -> Dict[Tuple[str, str], Any]:
    out = {}
    for key, v in after.items():
        if isinstance(v, dict):
            out[key] = {k: n - before[key].get(k, 0) for k, n in v.items()
                        if n != before[key].get(k, 0)}
        else:
            out[key] = v - before[key]
    return out


class StepGraphs:
    """``run(params, batch, t, noise, use_sc, use_cd, generator) -> (metrics, grad_norm)``:
    the gradients of ``loss_fn`` in the parameters' ``.grad`` and their global norm, by an
    eager step for a variant's first step and by the variant's CUDA graph afterwards.
    ``forward(batch, t, noise, use_sc, use_cd, generator)`` must run the loss with its
    dropout draws and return ``(loss, metrics)``."""

    def __init__(self, forward: Callable, device: torch.device):
        self.forward = forward
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.pool = None
        self.one = torch.ones((), device=device)
        self.grads: List[torch.Tensor] = []
        self.graphs: Dict[tuple, Any] = {}
        self.eager_keys: set = set()
        self._params: List[torch.Tensor] = []

    def _bind_grads(self, params) -> None:
        self._params = params
        if len(self.grads) != len(params):
            self.grads = [torch.zeros_like(p) for p in params]
        for p, g in zip(params, self.grads):
            if p.grad is not g:
                p.grad = g

    def _body(self, batch, t, noise, use_sc, flag, generator):
        torch._foreach_zero_(self.grads)
        loss, metrics = self.forward(batch, t, noise, use_sc, flag, generator)
        loss.backward()
        return metrics, global_norm(self.grads)

    def run(self, params, batch: Dict[str, torch.Tensor], t, noise, use_sc: bool,
            use_cd: bool, generator: torch.Generator):
        self._bind_grads(params)
        flag = self.one if use_cd else False
        key = (use_sc, bool(use_cd), id(generator), t.shape, noise.shape,
               tuple((k, v.shape, v.dtype) for k, v in sorted(batch.items())))
        entry = self.graphs.get(key)
        if entry is None and key not in self.eager_keys:
            self.eager_keys.add(key)
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self.stream):
                metrics, norm = self._body(batch, t, noise, use_sc, flag, generator)
            torch.cuda.current_stream(self.device).wait_stream(self.stream)
            return metrics, norm
        if entry is None:
            entry = self.graphs[key] = self._capture(batch, t, noise, use_sc, flag,
                                                     generator)
        graph, inputs, outputs, counts = entry
        for dst, src in zip(inputs, (t, noise, *(batch[k] for k in sorted(batch)))):
            dst.copy_(src)
        graph.replay()
        _add_counters(counts)
        metrics, norm = outputs
        return ({k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in metrics.items()},
                norm.clone())

    def _capture(self, batch, t, noise, use_sc, flag, generator):
        torch.cuda.synchronize(self.device)
        inputs = [t.clone(), noise.clone(), *(batch[k].clone() for k in sorted(batch))]
        s_t, s_noise, *rest = inputs
        s_batch = dict(zip(sorted(batch), rest))
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(generator)
        before = _read_counters()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
            outputs = self._body(s_batch, s_t, s_noise, use_sc, flag, generator)
        counts = _diff_counters(_read_counters(), before)
        _add_counters(counts, -1)  # a capture launches nothing; each replay does
        if any(p.grad is not g for p, g in zip(self._params, self.grads)):
            raise RuntimeError("backward replaced a gradient buffer during the capture")
        self.pool = graph.pool()
        torch.cuda.synchronize(self.device)
        return graph, inputs, outputs, counts
