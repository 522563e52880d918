"""Training loop (counterpart of ``vyomai_tpu.training.trainer``): AdamW
with optax's global-norm clipping and warmup/cosine schedules, a train step
with gradient accumulation, a JSONL metric logger and a thin ``Trainer``.

PyTorch updates in place, so the state's ``params`` is the model itself
and ``opt_state`` the ``torch.optim.AdamW`` holding the moments. Where
torch's defaults differ from optax's, the port follows optax:

- ``weight_decay`` is passed explicitly (torch's AdamW defaults to 0.01,
  ``make_optimizer`` to 0.0);
- clipping scales by ``max_norm / norm`` only when ``norm >= max_norm``
  (``optax.clip_by_global_norm``), not by ``max_norm / (norm + 1e-6)``;
- the schedule is evaluated at update count 0 for the first update, so
  with warmup the first step's learning rate is 0;
- the Adam moments are kept in the parameters' dtype, as optax does with
  ``mu_dtype=None`` (bf16 moments for bf16 params).

``grad_norm`` is the pre-clip global norm, reduced in fp32 (fp64 for fp64
gradients).
"""

import json
import math
import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch import nn


@dataclass(frozen=True)
class Optimizer:
    """What ``make_optimizer`` describes; :meth:`build` makes the torch
    objects for a set of parameters."""

    learning_rate: float
    clip_norm: Optional[float]
    weight_decay: float
    warmup_steps: int
    total_steps: Optional[int]
    schedule: str

    def lr_factor(self, count: int) -> float:
        """Multiplier of ``learning_rate`` at update ``count`` (0-based):
        optax's ``warmup_cosine_decay_schedule(0, lr, warmup, total)``,
        ``linear_schedule(0, lr, warmup)`` or a constant."""
        warmup = self.warmup_steps
        if count < warmup:
            return count / warmup
        if self.schedule == "cosine":
            decay = self.total_steps - warmup
            done = min(count - warmup, decay)
            return 0.5 * (1.0 + math.cos(math.pi * done / decay))
        return 1.0

    def build(self, params):
        """``(torch.optim.AdamW, LambdaLR)`` over ``params``."""
        opt = torch.optim.AdamW(params, lr=self.learning_rate,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=self.weight_decay)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, self.lr_factor)


def make_optimizer(learning_rate: float = 1e-4, *,
                   clip_norm: Optional[float] = 1.0,
                   weight_decay: float = 0.0, warmup_steps: int = 0,
                   total_steps: Optional[int] = None,
                   schedule: str = "constant",
                   kind: str = "adamw") -> Optimizer:
    """AdamW + global-norm clipping + optional warmup-cosine schedule."""
    if kind in ("muon", "adamw8bit"):
        raise NotImplementedError(f"optimizer {kind!r} is not ported yet")
    if kind != "adamw":
        raise ValueError(f"unknown optimizer kind: {kind!r}")
    if schedule == "cosine" and not total_steps:
        raise ValueError(
            "schedule='cosine' requires total_steps (silently running at "
            "constant LR is the surprise this error prevents)")
    if schedule == "cosine":
        warmup_steps = min(warmup_steps, max(total_steps - 1, 0))
    return Optimizer(learning_rate, clip_norm, weight_decay, warmup_steps,
                     total_steps, schedule)


@dataclass
class TrainState:
    params: nn.Module                     # updated in place
    opt_state: torch.optim.Optimizer      # holds the Adam moments
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0


def create_train_state(model: nn.Module, optimizer: Optimizer) -> TrainState:
    return TrainState(model, *optimizer.build(model.parameters()))


def global_norm(tensors) -> torch.Tensor:
    """``sqrt(sum ||t||^2)`` reduced in fp32 (fp64 for fp64 tensors)."""
    norms = [torch.linalg.vector_norm(
        t, dtype=torch.float64 if t.dtype == torch.float64
        else torch.float32) for t in tensors]
    return torch.linalg.vector_norm(torch.stack(
        [n.to(norms[0].dtype) for n in norms]))


def _clip_(grads, norm: torch.Tensor, max_norm: float):
    """optax's ``clip_by_global_norm``, in place and without a host sync."""
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(grads, scale)


def _microbatches(batch: dict, n: int):
    for key, x in batch.items():
        if x.shape[0] % n:
            raise ValueError(f"batch[{key!r}] has {x.shape[0]} rows, not a "
                             f"multiple of grad_accum_steps={n}")
    return [{k: x.reshape(n, x.shape[0] // n, *x.shape[1:])[i]
             for k, x in batch.items()} for i in range(n)]


def make_train_step(loss_fn: Callable, optimizer: Optimizer, *,
                    grad_accum_steps: int = 1):
    """Build a train step ``step(state, batch, generator=None) -> (state,
    metrics)``.

    ``loss_fn(model, batch, generator) -> (loss, aux_dict)``. With
    ``grad_accum_steps > 1`` every leading batch dim must be
    ``grad_accum_steps * microbatch``; gradients are averaged over the
    microbatches, and so are loss and aux. ``metrics`` holds ``loss``,
    the pre-clip ``grad_norm`` and the aux entries, as tensors (reading
    them is the caller's host sync).
    """

    def step(state: TrainState, batch: dict,
             generator: Optional[torch.Generator] = None):
        model, opt = state.params, state.opt_state
        opt.zero_grad(set_to_none=True)
        if grad_accum_steps == 1:
            loss, aux = loss_fn(model, batch, generator)
            loss.backward()
            loss = loss.detach()
        else:
            losses, auxs = [], []
            for mb in _microbatches(batch, grad_accum_steps):
                l, a = loss_fn(model, mb, generator)
                (l / grad_accum_steps).backward()
                losses.append(l.detach())
                auxs.append(a)
            loss = torch.stack(losses).mean()
            aux = {k: torch.stack([torch.as_tensor(a[k]) for a in auxs]
                                  ).mean(dim=0) for k in auxs[0]}
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        gnorm = global_norm(grads)
        if optimizer.clip_norm is not None:
            _clip_(grads, gnorm, optimizer.clip_norm)
        opt.step()
        state.scheduler.step()
        state.step += 1
        return state, {"loss": loss, "grad_norm": gnorm, **aux}

    return step


class MetricLogger:
    """JSONL metric sink with console prints."""

    def __init__(self, path: Optional[str] = None, print_every: int = 50):
        self.path = path
        self.print_every = print_every
        self._fh = open(path, "a") if path else None
        self._t0 = time.time()

    def log(self, step: int, metrics: dict):
        rec = {"step": int(step), "time": round(time.time() - self._t0, 3)}
        if metrics:   # one device-to-host copy for the whole dict
            values = list(metrics.values())
            dev = next((v.device for v in values
                        if isinstance(v, torch.Tensor)), None)
            flat = torch.stack([torch.as_tensor(v, device=dev).detach()
                                .double().reshape(()) for v in values])
            rec.update(zip(metrics, flat.tolist()))
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self.print_every and step % self.print_every == 0:
            print(" ".join(f"{k}={v}" for k, v in rec.items()))

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def __del__(self):
        self.close()


class Trainer:
    """Thin single-device loop. ``loss_fn(model, batch, generator) ->
    (loss, aux)``. Multi-device meshes are not ported yet."""

    def __init__(self, model: nn.Module, loss_fn: Callable, *,
                 optimizer: Optional[Optimizer] = None, mesh_shape=None,
                 grad_accum_steps: int = 1, log_path: Optional[str] = None):
        if mesh_shape is not None:
            raise NotImplementedError(
                "multi-device training (mesh_shape) is not ported yet")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer or make_optimizer()
        self.grad_accum_steps = grad_accum_steps
        self.logger = MetricLogger(log_path)
        self._step_fn = make_train_step(loss_fn, self.optimizer,
                                        grad_accum_steps=grad_accum_steps)

    def init_state(self, model: Optional[nn.Module] = None) -> TrainState:
        return create_train_state(model or self.model, self.optimizer)

    def step(self, state: TrainState, batch: dict,
             generator: Optional[torch.Generator] = None):
        return self._step_fn(state, batch, generator)

    def fit(self, state: TrainState, data_iter, *, num_steps: int,
            generator: Optional[torch.Generator] = None,
            log_every: int = 10) -> TrainState:
        for i in range(num_steps):
            state, metrics = self.step(state, next(data_iter), generator)
            # log the first step and every multiple of log_every (in step
            # numbering, state.step == i + 1)
            if i == 0 or (i + 1) % log_every == 0:
                self.logger.log(state.step, metrics)
        return state

    def close(self):
        self.logger.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

