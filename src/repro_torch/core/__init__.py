"""The paper's contribution: convergence bounds under volatile workers,
optimal spot bidding, preemptible-instance provisioning, and the elastic
synchronous-SGD mechanism."""
from repro_torch.core import (  # noqa: F401
    bidding,
    convergence,
    cost_model,
    elastic,
    preemption,
    provisioning,
    strategies,
)
