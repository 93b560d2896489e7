"""Entry ``zoo``: ``trainer.train_zoo(remat=...)``, the per-cell zoo
program (bf16 parameters beside float32 masters when the traffic's
``dtype`` is bfloat16), attention through K2 with ``flash_attention``. A
training grid: `training.measure` drives it."""
from bench.harness.training import measure  # noqa: F401  (the driver)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def model0(prog, tree):
    """One replica's carry from its float32 parameter tree: (params,
    momentum) in float32, or {params (bf16), master, opt}."""
    from repro_torch.optim.sgd import get_optimizer

    opt = get_optimizer(prog.job.optimizer, prog.job.momentum)
    if prog.traffic["dtype"] == "float32":
        return (tree, opt.init(tree))
    dt = prog.cfg.resolved_param_dtype()
    return {"params": _map(lambda x: x.to(dt), tree), "master": tree,
            "opt": opt.init(tree)}


def call(prog, state, tick0: int, n_ticks: int):
    from repro_torch.train import trainer

    t = prog.traffic
    return trainer.train_zoo(
        prog.job, prog.batch, prog.seeds, remat=t["remat"], n_ticks=n_ticks,
        n_batches=t["n_batches"], batch_fn=prog.batch_fn, init_state=state,
        tick0=tick0, device=prog.device)


def carry(prog, state, which: str):
    """The grid's parameters (the float32 masters where there are any) or
    SGD momentum, as trees of (S, R, ...) leaves."""
    m = state.model
    params, mom = (m["master"], m["opt"]) if isinstance(m, dict) else m
    return params if which == "params" else mom
