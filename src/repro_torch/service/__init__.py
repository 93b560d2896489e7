"""Rolling-horizon spot bidding service.

Closes the loop between the market simulator and the paper's optimizers:

- ``stream``    — replayed-streaming price feed (monotone wall clock,
  multi-market) over ``sim.spot_market.synthetic_history`` or on-disk
  traces (``sim.traces``),
- ``estimator`` — vectorized online posteriors per market: empirical price
  quantiles, Beta preemption probability, Gamma runtime rate,
- ``planner``   — candidate plans from ``core``'s theorems under the
  current posterior, scored in one batched engine call on the card (or
  the CPU when asked),
- ``server``    — the rolling-horizon loop driving many concurrent jobs
  against one shared feed, emitting ``decisions.jsonl`` and final regret
  vs. the hindsight-optimal static plan.
"""
from repro_torch.service.estimator import OnlineEstimator  # noqa: F401
from repro_torch.service.planner import Candidate, PlanRequest  # noqa: F401
from repro_torch.service.server import (BidServer, JobSpec,  # noqa: F401
                                        ServeConfig)
from repro_torch.service.stream import (FeedExhaustedError,  # noqa: F401
                                        FeedMonotonicityError, PriceFeed,
                                        feed_from_traces, synthetic_feed)
