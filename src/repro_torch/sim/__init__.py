"""Scenario engine of the port: deterministic cluster-lifecycle replay
through the serving stack (the port's own copy of the reference's
``sim`` package, cut to this slice).

* :mod:`repro_torch.sim.traces`   — seeded, JSON-replayable lifecycle
  scripts (the paper's stable, one-shot and incremental scenarios, and
  the reference's beyond-paper lifecycles),
* :mod:`repro_torch.sim.driver`   — replays a trace: host state → epoch
  deltas → ``DeviceImageStore`` → the lookup and diff kernels /
  ``SessionRouter``,
* :mod:`repro_torch.sim.checkers` — the per-event guarantee laws,
* :mod:`repro_torch.sim.metrics`  — movement, sync and throughput
  accumulation and the replay fingerprint, equal to the reference's.
"""
from .checkers import Violation, degradation_knee
from .driver import ScenarioDriver, ScenarioResult, pick_victim, replay, resolve_victims
from .metrics import EventRecord, ScenarioMetrics
from .traces import SCENARIOS, Trace, TraceEvent, make_trace

__all__ = [
    "EventRecord",
    "SCENARIOS",
    "ScenarioDriver",
    "ScenarioMetrics",
    "ScenarioResult",
    "Trace",
    "TraceEvent",
    "Violation",
    "degradation_knee",
    "make_trace",
    "pick_victim",
    "replay",
    "resolve_victims",
]
