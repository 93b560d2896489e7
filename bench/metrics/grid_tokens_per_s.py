"""The grid's training rate (tokens/s): the window's ticks × the grid's
cells × the tokens of one cell-step (``batch · (seq_len − 1)``), over the
window's seconds on the host's clock. Every cell's step is computed on
every tick, so the count does not depend on the market's draws, and a
stall anywhere in the window counts."""


def read(facts):
    if not facts.get("window_s") or "tokens_per_cell_step" not in facts:
        return None
    return facts["cell_steps"] * facts["tokens_per_cell_step"] \
        / facts["window_s"]
