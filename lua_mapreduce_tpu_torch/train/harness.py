"""Data-parallel training harness.

Port of ``lua_mapreduce_tpu/train/harness.py``: the same dataflow as
the reference example (grad on a batch → all-reduce → optimizer step →
loop, early stopping on a holdout set, checkpoints through a Store,
progress in a ``PersistentTable`` for resume), with
``torch.optim.SGD(lr, momentum, weight_decay)`` as the optimizer — the
same update as the JAX default ``optax.chain(add_decayed_weights,
sgd(momentum))``: g ← g + wd·p; buf ← momentum·buf + g; p ← p − lr·buf.

Without a mesh the trainer runs on one device. With one
(``parallel/mesh.py``), every rank of the world runs the trainer on the
same global batches: each takes its rows of a batch (the JAX harness's
``P(dp)`` sharding), the gradients are averaged over ``dp`` by an
all-reduce before the optimizer (``pmean``), and the reported loss is
the global mean. ``zero1=True`` shards the optimizer state over ``dp``
instead (``parallel/zero1.py``): gradients reduce-scatter, each rank
updates its chunks, the chunks all-gather back.

The JAX harness runs an epoch, and ``run_steps``, as one ``lax.scan``
under ``jit``. Here one training step — forward, backward (over
``grad_accum`` microbatches when > 1), the collectives and the
optimizer's update — is captured once per batch shape in a CUDA graph
over static batch buffers and replayed for every step: a replay makes
no host round trip. The first step at a shape runs eagerly (the
capture's warm-up, a real step; it also creates the NCCL communicators
outside the capture). On the CPU the same step function runs eagerly.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from lua_mapreduce_tpu_torch.device import resolve_device
from lua_mapreduce_tpu_torch.graphs import CapturedGraph, on_side_stream
from lua_mapreduce_tpu_torch.parallel import collectives as C
from lua_mapreduce_tpu_torch.parallel import zero1 as _z1
from lua_mapreduce_tpu_torch.train import checkpoint as ckpt
from lua_mapreduce_tpu_torch.train.accum import accum_value_and_grad
from lua_mapreduce_tpu_torch.train.optim import _materialize
from lua_mapreduce_tpu_torch.utils.profiling import device_trace


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
    # gradient accumulation: > 1 splits each batch into this many
    # microbatches folded before ONE optimizer update (train/accum.py) —
    # the same numbers as the whole batch, activation memory ÷ grad_accum
    grad_accum: int = 1
    # ZeRO-1: shard the optimizer state over the mesh's dp axis
    # (parallel/zero1.py) — gradients reduce-scatter, each rank updates
    # its 1/n_dp chunk, chunks all-gather back. Same wire traffic as the
    # all-reduce, optimizer memory / n_dp. Needs a mesh.
    zero1: bool = False
    # when set, the SECOND run_epoch call (the first captures its step)
    # is traced with utils/profiling.device_trace into this directory
    profile_dir: Optional[str] = None


@dataclasses.dataclass
class _StepGraph:
    """A captured training step: its static batch buffers and the graph
    whose output is the step's loss."""
    x: torch.Tensor
    y: torch.Tensor
    graph: CapturedGraph


class DataParallelTrainer:
    """Trainer for ``loss_fn(params, x, y) -> scalar``.

    ``params`` is a dict of tensors (or arrays); the trainer keeps its
    own copies on ``device`` (default ``"cuda"``) as leaf tensors that
    require grad, and steps them in place with the optimizer. ``mesh``
    (a ``parallel.mesh.Mesh``) makes the trainer data-parallel over its
    ``axis``: ``device`` is then the mesh's, and every rank makes the
    same calls. ``mesh`` is keyword-only: the JAX signature takes it
    third, where the port's single-device trainer already took
    ``config``.
    On a card every step is a replay of a captured CUDA graph;
    :attr:`traces` counts the captures (one per batch shape and dtype),
    as the JAX harness counts its traces. Each captured step keeps its
    graph and the graph's private memory pool for the trainer's
    lifetime, so every new batch shape pins one step's activations and
    gradients on the device.
    """

    def __init__(self, loss_fn: Callable, params: Dict[str, Any],
                 config: Optional[TrainConfig] = None,
                 device: Optional[Union[str, torch.device]] = None, *,
                 mesh=None, axis: str = "dp"):
        self.loss_fn = loss_fn
        self.config = c = config or TrainConfig()
        if c.grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {c.grad_accum}")
        if c.zero1 and mesh is None:
            raise ValueError("zero1 shards the optimizer state over a "
                             "mesh's dp axis: pass mesh=")
        self.mesh, self.axis = mesh, axis
        if mesh is None:
            self.device, self.n_dp = resolve_device(device), 1
        else:
            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError(f"device {device!r} is not the mesh's "
                                 f"{mesh.device}")
            self.device, self.n_dp = mesh.device, mesh.shape[axis]
        self.params = {k: torch.as_tensor(v).detach().to(self.device)
                       .clone().requires_grad_(True)
                       for k, v in params.items()}

        # the momentum buffers exist from the start (zeros: the first
        # step's 0·momentum + g is g), so a captured step updates them in
        # place and a resume can load into them
        def make_optimizer(leaves):
            return _materialize(torch.optim.SGD(
                list(leaves), lr=c.learning_rate, momentum=c.momentum,
                weight_decay=c.weight_decay))

        if c.zero1:
            self._chunks, self.optimizer = _z1.init_state(
                make_optimizer, self.params, mesh, dp_axis=axis)
        else:
            self.optimizer = make_optimizer(self.params.values())
        self._graphs: Dict[tuple, _StepGraph] = {}
        self.traces = 0
        self._epoch_calls = 0

    def _check_rows(self, rows: int) -> None:
        if rows % (self.n_dp * self.config.grad_accum):
            raise ValueError(
                f"batch of {rows} does not split over {self.axis}="
                f"{self.n_dp} × grad_accum={self.config.grad_accum}")

    def _rank_rows(self, rows: int) -> slice:
        """This rank's rows of a global batch of ``rows``."""
        per = rows // self.n_dp
        i = 0 if self.mesh is None else self.mesh.axis_index(self.axis)
        return slice(i * per, (i + 1) * per)

    def _shard_batch(self, x, y) -> Tuple[torch.Tensor, torch.Tensor]:
        """This rank's rows of the global batch (x, y), on the device."""
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        self._check_rows(x.shape[0])
        sl = self._rank_rows(x.shape[0])
        return x[sl].to(self.device), y[sl].to(self.device)

    def _grad_step(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """One step on this rank's rows: the loss and its gradient (the
        microbatch fold when grad_accum > 1; zeros where the loss does
        not reach a parameter, as under ``jax.grad``), with a mesh their
        means over dp, and the optimizer's update — under ZeRO-1 through
        the reduce-scatter / chunk update / all-gather of
        ``parallel/zero1.py``. The captured function: no host round
        trip. Returns the detached loss (the global mean)."""
        leaves = list(self.params.values())
        if self.config.grad_accum == 1:
            loss = self.loss_fn(self.params, x, y)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            loss = loss.detach()
        else:
            loss, gd = accum_value_and_grad(self.loss_fn, self.params,
                                            (x, y), self.config.grad_accum)
            grads = [gd[k] for k in self.params]
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        if self.mesh is not None:
            loss = C.pmean(loss, self.mesh, self.axis)
        if self.config.zero1:
            _z1.update_chunks(self.optimizer, self.params,
                              dict(zip(self.params, grads)), self._chunks,
                              self.mesh, self.axis)
            return loss
        for p, g in zip(leaves, grads):
            p.grad = (g if self.mesh is None
                      else C.pmean(g, self.mesh, self.axis))
        self.optimizer.step()
        return loss

    def _capture(self, x: torch.Tensor, y: torch.Tensor
                 ) -> Tuple[_StepGraph, torch.Tensor]:
        """Copy the batch into new static buffers, take one eager step
        on them (the warm-up; it is a real step) and capture the step.
        Returns the captured step and the eager step's loss."""
        sx, sy = x.clone(), y.clone()
        loss = on_side_stream(lambda: self._grad_step(sx, sy))
        # grads (of the ZeRO-1 chunks, which the optimizer steps, under
        # zero1) set to None: the capture makes them in the graph's pool,
        # where every replay rewrites them; until the first replay they
        # hold the eager step's
        holders = list((self._chunks if self.config.zero1
                        else self.params).values())
        eager = [t.grad for t in holders]
        for t in holders:
            t.grad = None
        graph = CapturedGraph(lambda: self._grad_step(sx, sy),
                              tag="train step")
        with torch.no_grad():
            for t, g in zip(holders, eager):
                t.grad.copy_(g)
        self.traces += 1
        return _StepGraph(sx, sy, graph), loss

    def _run(self, batch: Callable[[int], Tuple[torch.Tensor, torch.Tensor]],
             n: int) -> torch.Tensor:
        """``n`` optimizer steps, step i on ``batch(i)``; returns the
        per-step losses (a device tensor). On a card each step replays
        the captured step of its batch's shape after one device-to-
        device copy of the batch into the static buffers (none when the
        step's batch is the previous step's)."""
        if n <= 0:
            return torch.empty(0, device=self.device)
        if self.device.type != "cuda":
            return torch.stack([self._grad_step(*batch(i))
                                for i in range(n)])
        x, y = batch(0)
        key = (tuple(x.shape), x.dtype, tuple(y.shape), y.dtype,
               self.config.grad_accum)
        step = self._graphs.get(key)
        first, held = 0, None
        if step is None:
            step, loss = self._capture(x, y)
            self._graphs[key] = step
            losses = torch.empty(n, dtype=loss.dtype, device=self.device)
            losses[0] = loss
            first, held = 1, (x, y)
        else:
            losses = torch.empty(n, dtype=step.graph.output.dtype,
                                 device=self.device)
        for i in range(first, n):
            x, y = batch(i)
            if held is None or held[0] is not x or held[1] is not y:
                step.x.copy_(x)
                step.y.copy_(y)
                held = (x, y)
            losses[i] = step.graph.replay()
        return losses

    def step(self, x, y) -> float:
        """One optimizer step on one (global) batch; returns its loss."""
        x, y = self._shard_batch(x, y)
        return float(self._run(lambda i: (x, y), 1)[0])

    def run_steps(self, x, y, n_steps: int) -> torch.Tensor:
        """``n_steps`` optimizer steps on ONE fixed batch kept on the
        device — the compute hot loop: the batch is copied in once and
        the captured step replayed ``n_steps`` times, with no host sync
        between steps. Returns the per-step losses (a device tensor)."""
        x, y = self._shard_batch(x, y)
        return self._run(lambda i: (x, y), n_steps)

    def run_epoch(self, x: np.ndarray, y: np.ndarray,
                  rng: np.random.RandomState) -> float:
        """Shuffle, batch, and run one full epoch; returns the mean
        batch loss. Uses ``rng`` exactly as the JAX harness does, so the
        same seed gives the same batches. This rank's rows of the
        shuffled epoch (of every batch, its rows) go to the device in one
        copy; each step reads its batch as a view of them."""
        c = self.config
        self._check_rows(c.batch_size)
        n = (len(x) // c.batch_size) * c.batch_size
        order = rng.permutation(len(x))[:n]
        sl = self._rank_rows(c.batch_size)
        order = order.reshape(-1, c.batch_size)[:, sl].reshape(-1)
        xs, ys = (torch.as_tensor(x[order]).to(self.device),
                  torch.as_tensor(y[order]).to(self.device))
        bs = c.batch_size // self.n_dp
        self._epoch_calls += 1
        trace = (device_trace(c.profile_dir)
                 if c.profile_dir is not None and self._epoch_calls == 2
                 else contextlib.nullcontext())
        with trace:
            losses = self._run(
                lambda i: (xs[i * bs:(i + 1) * bs], ys[i * bs:(i + 1) * bs]),
                n // c.batch_size)
            return float(losses.float().mean())   # forced inside the trace

    def fit(self, x_train, y_train, x_val, y_val,
            eval_fn: Optional[Callable] = None,
            checkpoint_store=None, checkpoint_name: str = "model.ckpt",
            conf=None, log: Optional[Callable[[str], None]] = None
            ) -> Dict[str, Any]:
        """Train with holdout early stopping (the finalfn role,
        common.lua:144-202). ``checkpoint_store`` receives the best
        params as ``<name>`` and last-epoch params plus momentum buffers
        as ``<name>.resume``. ``conf`` (a ``coord.persistent_table.
        PersistentTable``) records ``epoch``, ``best_val`` and
        ``best_epoch`` after every epoch; when it holds an epoch and the
        store a resume file, training resumes after that epoch, with the
        parameters and momentum buffers loaded in place (a captured step
        reads them where it captured them). The resumed run first replays
        the finished epochs' shuffles, so it takes the batches a run that
        never stopped takes; the JAX harness restarts its shuffling rng
        at the seed there, a fault of the reference (ROADMAP C)."""
        c = self.config
        rng = np.random.RandomState(c.seed)
        xv = torch.as_tensor(x_val).to(self.device)
        yv = torch.as_tensor(y_val).to(self.device)
        # with a mesh, rank 0 writes the checkpoints and the table, and
        # every rank reads them after a barrier
        writer = self.mesh is None or dist.get_rank() == 0

        def default_eval(p, xx, yy):
            with torch.no_grad():
                return float(self.loss_fn(p, xx, yy))

        eval_fn = eval_fn or default_eval
        best_val, best_epoch = float("inf"), 0
        history = []
        t0 = time.time()
        # two checkpoints: "<name>" holds the best-validation params (the
        # deliverable), "<name>.resume" last-epoch params AND momentum
        resume_name = checkpoint_name + ".resume"
        start_epoch = 1
        self._barrier()
        if conf is not None and "epoch" in conf \
                and checkpoint_store is not None \
                and ckpt.exists(checkpoint_store, resume_name):
            self._load_resume(checkpoint_store, resume_name)
            start_epoch = int(conf["epoch"]) + 1
            best_val = float(conf.get("best_val", best_val))
            best_epoch = int(conf.get("best_epoch", 0))
            for _ in range(1, start_epoch):
                rng.permutation(len(x_train))
        for epoch in range(start_epoch, c.max_epochs + 1):
            train_loss = self.run_epoch(x_train, y_train, rng)
            val_loss = eval_fn(self.params, xv, yv)
            history.append({"epoch": epoch, "train_loss": train_loss,
                            "val_loss": val_loss})
            if log:
                log(f"epoch {epoch}: train={train_loss:.4f} "
                    f"val={val_loss:.4f}")
            if val_loss < best_val:
                best_val, best_epoch = val_loss, epoch
                if checkpoint_store is not None and writer:
                    ckpt.save_pytree(checkpoint_store, checkpoint_name,
                                     self.params)
            if checkpoint_store is not None:
                bufs = self.momentum_buffers()
                if writer:
                    ckpt.save_pytree(checkpoint_store, resume_name,
                                     (self.params, bufs))
            if conf is not None and writer:
                conf.set({"epoch": epoch, "best_val": best_val,
                          "best_epoch": best_epoch})
                conf.update()
            self._barrier()
            if epoch - best_epoch >= c.patience:
                break       # early stopping: no "loop"
        return {"epochs": len(history) + start_epoch - 1,
                "best_val": best_val, "best_epoch": best_epoch,
                "history": history, "wall_time": time.time() - t0}

    def _barrier(self) -> None:
        if self.mesh is not None:
            dist.barrier(**({"device_ids": [self.device.index]}
                            if self.device.type == "cuda" else {}))

    @torch.no_grad()
    def _load_resume(self, store, name: str) -> None:
        """Copy the resume checkpoint's params and momentum buffers into
        the live tensors (``copy_``: their storage stays the one a
        captured step reads); under ZeRO-1 each rank takes its chunk of
        every buffer."""
        like = {k: p.detach() for k, p in self.params.items()}
        params, saved = ckpt.load_pytree(store, name, (like, like),
                                         check_shapes=True,
                                         check_dtypes=True)
        for k, p in self.params.items():
            p.copy_(params[k])
            buf = self._momentum_slot(k)
            if buf is not None:
                src = saved[k].to(self.device)
                buf.copy_(_z1.chunk_of_rank(src, self.mesh, self.axis)
                          if self.config.zero1 else src)

    def _momentum_slot(self, k: str) -> Optional[torch.Tensor]:
        """The live momentum buffer of parameter ``k`` (of its chunk
        under ZeRO-1), or None with momentum 0."""
        t = self._chunks[k] if self.config.zero1 else self.params[k]
        return self.optimizer.state.get(t, {}).get("momentum_buffer")

    def momentum_buffers(self) -> Dict[str, torch.Tensor]:
        """The optimizer's momentum buffer per parameter (zeros before
        the first step; with momentum 0, zeros standing in for none).
        Under ZeRO-1 the chunks are all-gathered into whole buffers: a
        collective, so every rank calls it."""
        out = {}
        for k, p in self.params.items():
            buf = self._momentum_slot(k)
            like = self._chunks[k] if self.config.zero1 else p
            out[k] = buf if buf is not None else torch.zeros_like(like)
        if self.config.zero1:
            out = _z1.gather_params(out, self.params, self.mesh, self.axis)
        return out
