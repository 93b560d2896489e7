"""Deterministic fault injection for durable training (see chaos/plan.py
for the fault taxonomy and launch/supervisor.py for the restart loop that
survives it)."""
from repro_torch.chaos.inject import (FaultInjector, FaultLedger, FlakyIO,
                                      corrupt_checkpoint, poison_model)
from repro_torch.chaos.plan import CORRUPT_MODES, KINDS, Fault, FaultPlan

__all__ = ["Fault", "FaultPlan", "FaultInjector", "FaultLedger", "FlakyIO",
           "corrupt_checkpoint", "poison_model", "KINDS", "CORRUPT_MODES"]
