"""Fault-tolerant training runtime.

The JAX package's ``repro.runtime.trainer`` on one device:
  * deterministic stateless data (re-derive any batch from the step index)
  * async atomic checkpoints every `ckpt_every` steps
  * restart = load latest checkpoint + continue (bit-exact; tested by
    killing mid-run and comparing against an uninterrupted run)
  * straggler watchdog: steps exceeding `factor` x the median step time
    are flagged and counted.
The step runs eagerly (no ``jit``); parameters and optimizer state are
updated in place, as the JAX trainer donates them. A mesh and rules, as
in the JAX trainer, go to ``build_model`` (the vocab-sharded embedding);
``restore_or_init`` loads onto the model's device without shardings, as
the JAX trainer does (``checkpoint.load`` with shardings is the elastic
restore).

A bit-exact resume needs every operation of the step to give the same bits
on a rerun. On a CUDA device the ``Trainer`` turns on
``torch.use_deterministic_algorithms`` (process-wide): where PyTorch has a
deterministic and a faster nondeterministic form of an op, the first is
taken (on this path: the backward of the cross-entropy's ``gather``, a
``scatter_add``), and an op with only a nondeterministic form raises
instead of breaking the resume in silence. It also sets
``CUBLAS_WORKSPACE_CONFIG`` unless it is set, which cuBLAS reads when it
starts on a device.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import AsyncCheckpointer, latest, load
from repro_torch.common import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.lm_data import batch_for_step
from repro_torch.models import build_model, make_train_step
from repro_torch.optim import OptConfig, init_opt_state


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class StragglerWatchdog:
    factor: float = 3.0
    _times: list = dataclasses.field(default_factory=list)
    events: int = 0

    def observe(self, dt: float) -> bool:
        self._times.append(dt)
        med = float(np.median(self._times[-50:]))
        slow = len(self._times) > 5 and dt > self.factor * med
        if slow:
            self.events += 1
        return slow


class Trainer:
    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, workdir: str,
                 opt_cfg: OptConfig = OptConfig(), ckpt_every: int = 10,
                 seed: int = 0, device="cuda", mesh=None, rules=None):
        self.cfg, self.shape, self.workdir = cfg, shape, workdir
        self.opt_cfg, self.ckpt_every, self.seed = opt_cfg, ckpt_every, seed
        self.device = resolve_device(device, "Trainer")
        if self.device.type == "cuda":      # see the module docstring
            os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
            torch.use_deterministic_algorithms(True)
        self.model = build_model(cfg, mesh, rules, device=self.device)
        self.step_fn = make_train_step(self.model, opt_cfg)
        self.ckpt = AsyncCheckpointer(workdir)
        self.watchdog = StragglerWatchdog()

    def init_state(self):
        params = self.model.init_params(self.seed)
        return params, init_opt_state(params, self.opt_cfg)

    def restore_or_init(self):
        path = latest(self.workdir)
        params, opt_state = self.init_state()
        if path is None:
            return 0, params, opt_state
        step, trees = load(path, {"params": params, "opt_state": opt_state})
        return step, trees["params"], trees["opt_state"]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, num_steps: int, fail_at: int | None = None,
            hook: Callable[[int, dict], None] | None = None):
        """Run (or resume) to `num_steps`. Raises SimulatedFailure at step
        `fail_at` AFTER some un-checkpointed progress — the crash test."""
        start, params, opt_state = self.restore_or_init()
        metrics: dict[str, Any] = {}
        for step in range(start, num_steps):
            if fail_at is not None and step == fail_at:
                raise SimulatedFailure(f"injected failure at step {step}")
            batch = {k: torch.from_numpy(v).to(self.device) for k, v in
                     batch_for_step(self.cfg, self.shape, step, self.seed).items()}
            t0 = time.perf_counter()
            params, opt_state, metrics = self.step_fn(params, opt_state, batch)
            self._sync()
            self.watchdog.observe(time.perf_counter() - t0)
            if hook:
                hook(step, metrics)
            if (step + 1) % self.ckpt_every == 0:
                self.ckpt.save(step + 1, {"params": params,
                                          "opt_state": opt_state})
        self.ckpt.wait()
        return params, opt_state, metrics
