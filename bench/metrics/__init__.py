"""One reader per metric, end-to-end or per-layer, found by the metric's
name. Each has ``read(facts) -> float | None``: None where the run holds
nothing to read, and the harness then leaves the metric out of the line.

``facts`` holds what the cell's entry measured (for a training grid,
`harness.training.measure`: the ``grid`` (scenarios, seeds), the
configuration's ``leaves``, ``setup_s``, the window's host-clock
``window_s``, ``ticks``, ``cell_steps`` (every cell's step on every tick),
``running_steps`` (those that advanced an iteration),
``tokens_per_cell_step``, ``peak_window_bytes`` and the program's
``launch_counts`` over the window), and from the harness the cell's
``conf``, ``traffic`` and ``reference`` module and the card's ``peaks``
(None off the table). A traced run on a card adds ``trace_window_s``,
``busy_s``, ``kernels`` ({name: [launches, device seconds]}), ``trace``
(`harness.trace.collect`) and ``breakdown``."""
