"""The program under test, driven through its public entry.

A cell's configuration names its port module (``bench/ports/<config>.py``:
the model config and the launcher's flags) and its traffic names its entry
(``bench/entries/<entry>.py``: how one replica's carry is made, how the
trainer is called over a range of ticks, and where the carry keeps its
parameters and momentum). Both take the launcher's own scenario
(`launch.train.build_trainer` and ``ElasticTrainer._scenario``) and run in
chunks of ticks resumed by ``init_state``/``tick0``, as
``train_batched_durable`` runs. The benchmark hands in the weights, one
set per replica, and the batches (``batch_fn``); the program reports its
carry, whose leaves are read here only to be judged."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import numpy as np
import torch

from bench.harness import weights as wmod


def batch_maker(seed: int, batch: int, seq_len: int,
                vocab: int) -> Callable[[int], Dict[str, np.ndarray]]:
    """Batch ``j`` of the run: ``batch`` rows of ``seq_len`` token ids
    uniform over the vocabulary, drawn from (seed, j); the inputs are
    positions 0 … seq_len-2 and the labels 1 … seq_len-1, as in the
    launcher's batches."""
    def batch_fn(j: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng([int(seed), int(j)])
        toks = rng.integers(0, vocab, (batch, seq_len), dtype=np.int64)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    return batch_fn


def grid_seeds(seed: int, n: int) -> List[int]:
    """The market seeds of the grid's replicas."""
    return [int(seed) + r for r in range(n)]


class Program:
    """One cell's trainer, scenario grid and feed, built on ``device``."""

    def __init__(self, cell, seed: int, device):
        from repro_torch.launch import train as launch
        from repro_torch.sim import engine

        conf, t = cell.config, cell.traffic
        self.port, self.entry = cell.port, cell.entry
        self.conf, self.traffic, self.device = conf, t, device
        self.cfg = self.port.model_config(conf, t)
        args = launch.build_parser().parse_args(
            self.port.launcher_args(conf) +
            ["--workers", str(t["workers"]), "--batch", str(t["batch"]),
             "--seq", str(t["seq_len"]), "--strategy", t["strategy"],
             "--price", t["price"], "--eps", str(t["eps"]),
             "--theta", str(t["theta"]),
             "--device", torch.device(device).type])
        trainer = launch.build_trainer(args)
        self.job = dataclasses.replace(
            trainer.job, model=self.cfg, learning_rate=t["learning_rate"],
            momentum=t["momentum"])
        trainer.job = self.job
        scenario = trainer._scenario(trainer.strategy, t["iterations"],
                                     t["strategy"])
        self.scenarios = [scenario] * t["scenarios"]
        self.batch = engine.stack_scenarios(self.scenarios, device=device)
        self.seeds = grid_seeds(seed, t["seeds"])
        self.batch_fn = batch_maker(seed, t["batch"], t["seq_len"],
                                    conf["vocab_size"])
        self.grid = (t["scenarios"], t["seeds"])

    def initial_state(self, leaves, seed: int):
        """The grid's carry: cell ``i`` (scenario-major) starts from its
        own weights, `weights.make_all(leaves, seed, device, i)`. One
        replica's tree at a time is alive besides the grid's."""
        from repro_torch.train import trainer

        s_dim, r_dim = self.grid

        def model0(i):
            flat = wmod.make_all(leaves, seed, self.device, i)
            return self.entry.model0(self, self.port.to_program(flat))

        state = trainer.batched_init_state(
            self.job, self.batch, self.seeds, model0=lambda: model0(0),
            device=self.device)
        for i in range(1, s_dim * r_dim):
            _put_cell(state.model, model0(i), *divmod(i, r_dim))
        return state

    def call(self, state, tick0: int, n_ticks: int):
        """The public entry over ticks ``tick0 … n_ticks-1`` from carry
        ``state``."""
        return self.entry.call(self, state, tick0, n_ticks)

    def leaves(self, state, which: str) -> Dict[str, torch.Tensor]:
        """{path: (S, R, ...) view} of the carry's parameters (``params``,
        the float32 masters where there are any) or SGD momentum
        (``mom``)."""
        return self.port.from_program(self.entry.carry(self, state, which),
                                      2)


def _put_cell(grid_tree, tree, s: int, r: int) -> None:
    """Write one replica's carry ``tree`` into cell (s, r) of the grid's."""
    if isinstance(grid_tree, dict):
        for k in grid_tree:
            _put_cell(grid_tree[k], tree[k], s, r)
    elif isinstance(grid_tree, (tuple, list)):
        for g, x in zip(grid_tree, tree):
            _put_cell(g, x, s, r)
    else:
        grid_tree[s, r].copy_(tree)
