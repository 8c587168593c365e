"""Single-device training harness.

Port of ``lua_mapreduce_tpu/train/harness.py`` for one device: the same
dataflow as the reference example (grad on a batch → optimizer step →
loop, early stopping on a holdout set, checkpoints through a Store),
with ``torch.optim.SGD(lr, momentum, weight_decay)`` as the optimizer —
the same update as the JAX default ``optax.chain(add_decayed_weights,
sgd(momentum))``: g ← g + wd·p; buf ← momentum·buf + g; p ← p − lr·buf.

The JAX harness's multi-device pieces — the dp mesh and its all-reduce,
ZeRO-1, gradient accumulation, the ``lax.scan`` epoch — are later
slices. Steps run eagerly, one Python iteration each.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch

from lua_mapreduce_tpu_torch.device import resolve_device
from lua_mapreduce_tpu_torch.train import checkpoint as ckpt


@dataclasses.dataclass
class TrainConfig:
    """Hyperparameters (the reference example's structure,
    examples/APRIL-ANN/init.lua:16-20), with the JAX harness's
    defaults."""
    learning_rate: float = 0.05
    momentum: float = 0.9
    weight_decay: float = 1e-5      # init.lua weight_decay
    batch_size: int = 128           # "bunch_size" init.lua:127-141
    max_epochs: int = 40            # init.lua max epochs
    patience: int = 10              # train_holdout_validation analog
    seed: int = 1234


class DataParallelTrainer:
    """Trainer for ``loss_fn(params, x, y) -> scalar`` on one device.

    ``params`` is a dict of tensors (or arrays); the trainer keeps its
    own copies on ``device`` (default ``"cuda"``) as leaf tensors that
    require grad, and steps them in place with the optimizer.
    """

    def __init__(self, loss_fn: Callable, params: Dict[str, Any],
                 config: Optional[TrainConfig] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.loss_fn = loss_fn
        self.config = config or TrainConfig()
        self.device = resolve_device(device)
        self.params = {k: torch.as_tensor(v).detach().to(self.device)
                       .clone().requires_grad_(True)
                       for k, v in params.items()}
        c = self.config
        self.optimizer = torch.optim.SGD(
            list(self.params.values()), lr=c.learning_rate,
            momentum=c.momentum, weight_decay=c.weight_decay)

    def _to_device(self, x, y):
        return (torch.as_tensor(x).to(self.device),
                torch.as_tensor(y).to(self.device))

    def _step(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss_fn(self.params, x, y)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def step(self, x, y) -> float:
        """One optimizer step on one batch; returns its loss."""
        x, y = self._to_device(x, y)
        return float(self._step(x, y))

    def run_steps(self, x, y, n_steps: int) -> torch.Tensor:
        """``n_steps`` optimizer steps on ONE fixed batch kept on the
        device — the compute hot loop, with no host sync between steps.
        Returns the per-step losses (a device tensor)."""
        x, y = self._to_device(x, y)
        return torch.stack([self._step(x, y) for _ in range(n_steps)])

    def run_epoch(self, x: np.ndarray, y: np.ndarray,
                  rng: np.random.RandomState) -> float:
        """Shuffle, batch, and run one full epoch; returns the mean
        batch loss. Uses ``rng`` exactly as the JAX harness does, so the
        same seed gives the same batches."""
        c = self.config
        n = (len(x) // c.batch_size) * c.batch_size
        order = rng.permutation(len(x))[:n]
        xs, ys = self._to_device(x[order], y[order])
        losses = [self._step(xs[i:i + c.batch_size], ys[i:i + c.batch_size])
                  for i in range(0, n, c.batch_size)]
        return float(torch.stack(losses).float().mean())

    def fit(self, x_train, y_train, x_val, y_val,
            eval_fn: Optional[Callable] = None,
            checkpoint_store=None, checkpoint_name: str = "model.ckpt",
            log: Optional[Callable[[str], None]] = None) -> Dict[str, Any]:
        """Train with holdout early stopping (the finalfn role,
        common.lua:144-202). ``checkpoint_store`` receives the best
        params as ``<name>`` and last-epoch params plus momentum buffers
        as ``<name>.resume``."""
        c = self.config
        rng = np.random.RandomState(c.seed)
        xv, yv = self._to_device(x_val, y_val)

        def default_eval(p, xx, yy):
            with torch.no_grad():
                return float(self.loss_fn(p, xx, yy))

        eval_fn = eval_fn or default_eval
        best_val, best_epoch = float("inf"), 0
        history = []
        t0 = time.time()
        for epoch in range(1, c.max_epochs + 1):
            train_loss = self.run_epoch(x_train, y_train, rng)
            val_loss = eval_fn(self.params, xv, yv)
            history.append({"epoch": epoch, "train_loss": train_loss,
                            "val_loss": val_loss})
            if log:
                log(f"epoch {epoch}: train={train_loss:.4f} "
                    f"val={val_loss:.4f}")
            if val_loss < best_val:
                best_val, best_epoch = val_loss, epoch
                if checkpoint_store is not None:
                    ckpt.save_pytree(checkpoint_store, checkpoint_name,
                                     self.params)
            if checkpoint_store is not None:
                ckpt.save_pytree(checkpoint_store,
                                 checkpoint_name + ".resume",
                                 (self.params, self.momentum_buffers()))
            if epoch - best_epoch >= c.patience:
                break       # early stopping: no "loop"
        return {"epochs": len(history), "best_val": best_val,
                "best_epoch": best_epoch, "history": history,
                "wall_time": time.time() - t0}

    def momentum_buffers(self) -> Dict[str, torch.Tensor]:
        """The optimizer's momentum buffer per parameter (zeros before
        the first step)."""
        out = {}
        for k, p in self.params.items():
            buf = self.optimizer.state.get(p, {}).get("momentum_buffer")
            out[k] = buf if buf is not None else torch.zeros_like(p)
        return out
