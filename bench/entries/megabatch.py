"""Entry ``megabatch``: ``trainer.train_batched(megabatch=True,
use_fused_update=...)``, the replica-blocked float32 program with the
fused elastic update (K1), which is what ``python -m
repro_torch.launch.train --batched --megabatch --fused-update`` runs. A
training grid: `training.measure` drives it."""
from bench.harness.training import measure  # noqa: F401  (the driver)


def model0(prog, tree):
    """One replica's carry from its parameter tree: the flat {p, v}."""
    from repro_torch.train import megabatch

    return megabatch.pack_state(tree, (), prog.cfg, 0.0)


def call(prog, state, tick0: int, n_ticks: int):
    from repro_torch.train import trainer

    t = prog.traffic
    return trainer.train_batched(
        prog.job, prog.batch, prog.seeds, megabatch=True,
        use_fused_update=bool(t["fused_update"]), n_ticks=n_ticks,
        n_batches=t["n_batches"], batch_fn=prog.batch_fn, init_state=state,
        tick0=tick0, device=prog.device)


def carry(prog, state, which: str):
    """The grid's parameters (``params``) or SGD momentum (``mom``) as
    trees of (S, R, ...) views."""
    from repro_torch.train import megabatch

    params, mom = megabatch.unpack_state(state.model, prog.cfg,
                                         float(prog.job.momentum))
    return params if which == "params" else mom
