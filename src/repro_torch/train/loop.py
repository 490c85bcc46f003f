"""Training loop with fault tolerance and straggler monitoring, the twin of
the JAX package's ``train/loop.py``.

``Trainer`` runs eager train steps (``model.loss(params, batch,
remat=True)``, ``backward()``, an in-place AdamW update: no
``torch.compile`` and no CUDA graph, as the wave engine) over the data
pipeline, with:

* periodic and final atomic checkpoints (async writer),
* automatic restore on start (the resume is exact: the pipeline's state
  lives in the checkpoint),
* the ``train.step`` fault-injection site (:mod:`repro_torch.reliability.faults`),
  with the ``FaultInjector`` shim over it,
* a step-time watchdog that flags stragglers (slow steps).

The step differentiates through ``oplib``'s ``torch`` backend, as the
reference's does through ``jnp``: the hand-written kernels have no
backward (ROADMAP C11), so the ``Trainer`` refuses to start on the
``cuda`` backend.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .. import tree as T
from ..core import oplib
from ..data.pipeline import DataConfig, DataPipeline, PipelineState
from ..kernels._build import KernelAutogradError
from ..optim import adamw
from ..reliability import faults
from . import checkpoint as ckpt


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    ckpt_dir: str = ""
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0  # step slower than 3x median => straggler


class FaultInjector:
    """Raises at a chosen step (tests: simulated preemption).

    A compat shim over :mod:`repro_torch.reliability.faults`: it builds a
    one-shot ``train.step`` rule and checks it directly, so call sites
    that pass ``Trainer.run(fault=...)`` keep working while new code
    installs plans with ``faults.inject(...)``."""

    def __init__(self, fail_at_step: Optional[int] = None):
        self.fail_at_step = fail_at_step
        self._rule = (faults.fail_when(
            "train.step", lambda ctx: ctx["step"] == fail_at_step)
            if fail_at_step is not None else None)
        self._plan = (faults.FaultPlan([self._rule])
                      if self._rule is not None else None)

    @property
    def fired(self) -> bool:
        return self._rule is not None and self._rule.fired > 0

    def check(self, step: int) -> None:
        if self._plan is not None:
            self._plan.hit("train.step", step=step)


class StragglerWatchdog:
    def __init__(self, factor: float = 3.0):
        self.times: list = []
        self.factor = factor
        self.flagged: list = []

    def record(self, step: int, dt: float) -> None:
        self.times.append(dt)
        if len(self.times) >= 8:
            med = float(np.median(self.times[-64:]))
            if dt > self.factor * med:
                self.flagged.append({"step": step, "dt": dt, "median": med})


def loss_and_grads(model, params: Any, batch: Dict[str, torch.Tensor],
                   remat: bool = True) -> Tuple[torch.Tensor, list]:
    """``model.loss(params, batch, remat=)`` and ``backward()``: the loss
    (detached) and every parameter's gradient in the tree's leaf order,
    each parameter's ``.grad`` cleared.  A parameter the loss does not
    reach (the VLM's ``patch_proj`` on a text batch) gets a zero
    gradient, as ``jax.grad`` gives it."""
    flat = T.leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss, _ = model.loss(params, batch, remat=remat)
    loss.backward()
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in flat]
    for p in flat:
        p.grad = None
    return loss.detach(), grads


class Trainer:
    """``Trainer(model, opt_cfg, data_cfg, train_cfg, gen=None,
    device="cuda")``: the parameters are drawn from ``gen`` (a
    ``torch.Generator``; by default one on ``device`` seeded 0, where the
    reference takes ``rng=PRNGKey(0)``) onto ``device``, the card unless
    the caller passes ``"cpu"``; without a card that raises."""

    def __init__(self, model, opt_cfg: adamw.AdamWConfig, data_cfg: DataConfig,
                 train_cfg: TrainConfig, gen: Optional[torch.Generator] = None,
                 device="cuda"):
        if oplib.get_backend() != "torch":
            raise KernelAutogradError(
                f"Trainer: oplib's backend is {oplib.get_backend()!r}; its kernels have no "
                f"backward (ROADMAP C11): train on the 'torch' backend")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: device 'cuda' but torch.cuda.is_available() is "
                               "False; pass device='cpu' to train on the CPU")
        self.model = model
        self.opt_cfg = opt_cfg
        self.data_cfg = data_cfg
        self.cfg = train_cfg
        self.gen = gen if gen is not None else torch.Generator(device=self.device).manual_seed(0)
        self.params = model.init(self.gen, device=self.device)
        self.opt_state = adamw.init_state(self.params)
        self.step = 0
        self.history: list = []
        self.watchdog = StragglerWatchdog(train_cfg.straggler_factor)
        self.checkpointer = (ckpt.AsyncCheckpointer(train_cfg.ckpt_dir, train_cfg.keep)
                             if train_cfg.ckpt_dir else None)
        self.pipeline = DataPipeline(data_cfg)
        if train_cfg.ckpt_dir:
            self._maybe_restore()

    # ---------------------------------------------------------------- step
    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One step in place: :func:`loss_and_grads` (with remat), then
        AdamW on every parameter."""
        loss, grads = loss_and_grads(self.model, self.params, batch)
        info = adamw.apply_updates_(self.params, T.unflatten(T.flatten(self.params)[1], grads),
                                    self.opt_state, self.opt_cfg)
        return {"loss": loss, **info}

    # ------------------------------------------------------------- restore
    def _maybe_restore(self) -> None:
        last = ckpt.latest_step(self.cfg.ckpt_dir)
        if last is None:
            return
        step, state = ckpt.restore(self.cfg.ckpt_dir, {
            "params": self.params,
            "opt_state": self.opt_state,
            "data": {"step": np.zeros((), np.int64)},
        }, device=self.device)
        self.params = state["params"]
        self.opt_state = state["opt_state"]
        self.step = step
        self.pipeline.restore(PipelineState(step=int(state["data"]["step"])))

    def _save(self) -> None:
        if self.checkpointer is None:
            return
        self.checkpointer.save(self.step, {
            "params": self.params,
            "opt_state": self.opt_state,
            "data": {"step": np.asarray(self.pipeline.state.step, np.int64)},
        })

    # ----------------------------------------------------------------- run
    def run(self, fault: Optional[FaultInjector] = None) -> Dict[str, Any]:
        """Train to ``train_cfg.steps``.  ``history`` holds ``{step, loss,
        dt}`` (``dt`` in seconds, host clock, the card synchronized) and,
        beside them, the step's ``grad_norm`` and ``lr``."""
        while self.step < self.cfg.steps:
            t0 = time.perf_counter()
            batch = self.pipeline.next()
            batch = {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}
            if fault is not None:
                fault.check(self.step)
            # ambient fault plans (faults.inject) hit the same site without
            # threading an injector through the call stack
            faults.check("train.step", step=self.step)
            metrics = self.train_step(batch)
            loss = float(metrics["loss"])
            self.step += 1
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            self.watchdog.record(self.step, dt)
            if self.step % self.cfg.log_every == 0 or self.step == self.cfg.steps:
                self.history.append({"step": self.step, "loss": loss, "dt": dt,
                                     "grad_norm": float(metrics["grad_norm"]),
                                     "lr": float(metrics["lr"])})
            if self.cfg.ckpt_dir and (self.step % self.cfg.ckpt_every == 0
                                      or self.step == self.cfg.steps):
                self._save()
        if self.checkpointer is not None:
            self.checkpointer.wait()
        return {"final_loss": self.history[-1]["loss"] if self.history else None,
                "history": self.history,
                "stragglers": self.watchdog.flagged}


def run_with_restarts(make_trainer: Callable[[], Trainer],
                      fault: Optional[FaultInjector] = None,
                      max_restarts: int = 3) -> Dict[str, Any]:
    """Fault-tolerant driver: on failure, rebuild the trainer (which
    restores from the last checkpoint) and continue.  Each trainer's
    prefetch thread is stopped when its run ends, failed or not."""
    restarts = 0
    while True:
        trainer = make_trainer()
        try:
            out = trainer.run(fault)
            out["restarts"] = restarts
            return out
        except RuntimeError:
            restarts += 1
            if restarts > max_restarts:
                raise
        finally:
            trainer.pipeline.close()
