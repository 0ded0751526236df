"""Trainer supervisor: the Bento upgrade protocol applied to training.

The port's copy of ``repro/train/trainer.py``. One quiesce -> extract ->
restore protocol (``core.upgrade``) gives four fault-tolerance features:

  * checkpoint/restart  — extract -> serialize through the Bento FS,
  * failure recovery    — the supervisor catches worker failures (injected
                          in tests via ``failure_hook``), restores the last
                          checkpoint and replays deterministically,
  * elastic rescale     — extract -> rebuild for a new mesh -> restore,
  * online upgrade      — swap the model/optimizer module version mid-run
                          with state migration (``core.upgrade.transfer_state``).

Without a mesh, parameters and optimizer state live whole on ``device``
(CUDA unless the caller asks for the CPU). With one, every leaf is a
``distributed.sharding.MeshArray``: each mesh cell holds its FSDP x model
shard of it on the cell's device (its own card on a mesh of real cards;
the one card on a virtual mesh, ``launch.mesh.make_elastic_mesh`` over
copies of it), the step is partitioned over the mesh (``train.step``),
and checkpoints are cut and restored by the same shardings.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.interface import BentoModule
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import MeshArray, ShardingCtx, place
from repro_torch.launch.mesh import mesh_axis_sizes
from repro_torch.launch.programs import _ns_tree
from repro_torch.models import lm, params as P
from repro_torch.optim.adamw import adamw_init_specs
from repro_torch.train.step import make_train_step


class WorkerFailure(Exception):
    """Simulated node loss (tests inject it via failure_hook)."""


def _to(tree, device: torch.device):
    """A copy of every tensor of ``tree`` on ``device``, a ``MeshArray``
    gathered whole."""
    return P.tree_map(lambda t: t.gather(device) if isinstance(t, MeshArray)
                      else t.detach().to(device, copy=True), tree)


def _placed(tree, shardings):
    """Each leaf of ``tree`` laid out by its sharding (``place``)."""
    return P.tree_map(place, tree, shardings)


class Trainer(BentoModule):
    NAME = "trainer"
    VERSION = 1

    def __init__(self, cfg: ModelConfig, run: RunConfig, *, global_batch: int,
                 seq_len: int, mesh=None, ruleset: str = "baseline",
                 seed: int = 0, ckpt_view=None, ckpt_root: str = "/ckpt",
                 ckpt_every: int = 0, ckpt_pipeline_depth: Optional[int] = None,
                 failure_hook: Optional[Callable[[int], None]] = None,
                 data=None, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg, self.run = cfg, run
        self.global_batch, self.seq_len = global_batch, seq_len
        self.seed = seed
        self.ckpt_view, self.ckpt_root, self.ckpt_every = ckpt_view, ckpt_root, ckpt_every
        # None defers to the checkpoint store's default/env knob; 0 pins
        # the serial reference engine (restores stay byte-identical)
        self.ckpt_pipeline_depth = ckpt_pipeline_depth
        self.failure_hook = failure_hook
        self.metrics_log: list = []
        self.recoveries = 0
        self.data = data or SyntheticLM(cfg, global_batch, seq_len, seed=seed)
        self._build(mesh, ruleset)
        self._init_state()
        self.step_idx = 0
        self.last_restore_stats: Dict[str, Any] = {}
        self._prefetch: Optional[Prefetcher] = None

    # --- build / init -----------------------------------------------------------
    def _build(self, mesh, ruleset: str) -> None:
        self.mesh = mesh
        self.ruleset = ruleset
        self.ctx = (ShardingCtx.for_mesh(mesh, ruleset) if mesh is not None
                    else ShardingCtx.null())
        self.pspecs = lm.param_specs(self.cfg)
        self.ospecs = adamw_init_specs(self.pspecs, self.run)
        self._step_fn = make_train_step(self.cfg, self.run, self.ctx,
                                        self.global_batch)
        self.param_shardings = _ns_tree(self.pspecs, self.ctx)
        self.opt_shardings = _ns_tree(self.ospecs, self.ctx)

    def _init_state(self) -> None:
        # one seed for both trees, as the reference draws both from one
        # key; on a mesh each leaf is laid out before the next is drawn
        def gen():
            return torch.Generator(device=self.device).manual_seed(self.seed)
        self.params = P.materialize(self.pspecs, gen(), self.device,
                                    dtype=self.run.param_dtype,
                                    shardings=self.param_shardings)
        self.opt_state = P.materialize(self.ospecs, gen(), self.device,
                                       dtype="float32",
                                       shardings=self.opt_shardings)

    # --- stepping ------------------------------------------------------------------
    def _fetch(self, step: int) -> Dict[str, np.ndarray]:
        return self.data.batch(step)

    def train(self, n_steps: int) -> Dict[str, float]:
        """Supervised loop with recovery; returns final metrics."""
        last = {}
        self._prefetch = Prefetcher(self._fetch, start_step=self.step_idx)
        try:
            while self.step_idx < n_steps:
                try:
                    if self.failure_hook is not None:
                        self.failure_hook(self.step_idx)
                    sidx, batch = self._prefetch.next()
                    assert sidx == self.step_idx, (sidx, self.step_idx)
                    last = self.run_step(batch)
                    if (self.ckpt_every and self.ckpt_view is not None
                            and self.step_idx % self.ckpt_every == 0):
                        self.save_checkpoint()
                except WorkerFailure:
                    self.recoveries += 1
                    self.recover()
        finally:
            if self._prefetch:
                self._prefetch.close()
                self._prefetch = None
        return last

    def run_step(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        """One step on a host batch, which goes to the device here."""
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                 for k, v in batch.items()}
        self.params, self.opt_state, metrics = self._step_fn(
            self.params, self.opt_state, batch)
        m = {k: float(v) for k, v in metrics.items()}
        m["step"] = self.step_idx
        self.metrics_log.append(m)
        self.step_idx += 1
        return m

    # --- §4.8 state transfer ------------------------------------------------------------
    def extract_state(self) -> Dict[str, Any]:
        """The trainer's state with every tensor copied to the host (a
        ``MeshArray`` gathered whole)."""
        cpu = torch.device("cpu")
        return {
            "params": _to(self.params, cpu),
            "opt_state": _to(self.opt_state, cpu),
            "step": self.step_idx,
            "seed": self.seed,
        }

    def restore_state(self, state: Dict[str, Any], from_version: int = 1) -> None:
        if self.mesh is None:
            self.params = _to(state["params"], self.device)
            self.opt_state = _to(state["opt_state"], self.device)
        else:
            self.params = _placed(state["params"], self.param_shardings)
            self.opt_state = _placed(state["opt_state"], self.opt_shardings)
        self.step_idx = state["step"]
        new_seed = state.get("seed", self.seed)
        if new_seed != self.seed and isinstance(self.data, SyntheticLM):
            self.data = SyntheticLM(self.cfg, self.global_batch, self.seq_len,
                                    seed=new_seed)
        self.seed = new_seed

    def state_schema(self):
        return ("params", "opt_state", "step", "seed")

    # --- checkpoint / recovery -------------------------------------------------------------
    def _ckpt_shardings(self):
        if self.param_shardings is None:
            return None
        return {"params": self.param_shardings, "opt": self.opt_shardings}

    def save_checkpoint(self) -> None:
        """Shard-per-file v2 save: the live shardings become the stored
        shard grid, so a restart on a different mesh reshards on restore
        instead of gathering full tensors."""
        assert self.ckpt_view is not None
        root = f"{self.ckpt_root}/step_{self.step_idx:08d}"
        extra = None
        if self.mesh is not None:
            extra = {"mesh_axes": mesh_axis_sizes(self.mesh),
                     "ruleset": self.ruleset}
        ckpt.save(self.ckpt_view, root,
                  {"params": self.params, "opt": self.opt_state},
                  step=self.step_idx, shardings=self._ckpt_shardings(),
                  extra=extra, pipeline_depth=self.ckpt_pipeline_depth)

    def restore_checkpoint(self, step: Optional[int] = None) -> bool:
        assert self.ckpt_view is not None
        if step is None:
            step = ckpt.latest_step(self.ckpt_view, self.ckpt_root)
        if step is None:
            return False
        root = f"{self.ckpt_root}/step_{step:08d}"
        like = {"params": self.params, "opt": self.opt_state}
        self.last_restore_stats = {}
        tree, _mf = ckpt.load(
            self.ckpt_view, root, like,
            sharding_tree=self._ckpt_shardings(),
            stats=self.last_restore_stats,
            pipeline_depth=self.ckpt_pipeline_depth, device=self.device)
        self.params, self.opt_state = tree["params"], tree["opt"]
        self.step_idx = step
        # job-restart latency is the fleet-scale payoff: report how much
        # of the restore's fetch work the pipeline hid behind assembly
        pipe = self.last_restore_stats.get("pipeline", {})
        self.last_restore_stats["overlap_ratio"] = \
            pipe.get("overlap_ratio", 0.0)
        return True

    def recover(self) -> None:
        """Node-failure path: restore last durable state and replay."""
        if self._prefetch:
            self._prefetch.close()
        if self.ckpt_view is not None and self.restore_checkpoint():
            pass  # restored from FS
        else:
            self._init_state()  # cold restart
            self.step_idx = 0
        self._prefetch = Prefetcher(self._fetch, start_step=self.step_idx)

    # --- elastic rescale ----------------------------------------------------------------------
    def elastic_rescale(self, new_mesh, ruleset: str = "baseline") -> None:
        """Quiesce -> extract -> rebuild for the new mesh -> restore onto
        its cells."""
        state = self.extract_state()
        if self._prefetch:
            self._prefetch.close()
            self._prefetch = None
        self._build(new_mesh, ruleset)
        self.restore_state(state)
