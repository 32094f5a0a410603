"""Test-harness subsystems that run the production stack under adversity.

`faults` drives the streaming/fedtrain runtimes through seeded byte-level
chaos (corrupt/truncate/drop/duplicate/reorder/re-chunk) via the engines'
`wrap_endpoint` hook — the proof harness for the frame layer's CRC +
typed-error + reconnect/replay guarantees. `clock` is the injectable time source that lets the
same timing-dependent runtime code run under real threads or a
deterministic single-threaded simulation (`runtime.loadgen`).
"""
from repro_torch.testing.clock import (Clock, SYSTEM_CLOCK, SystemClock,
                                 VirtualClock)
from repro_torch.testing.faults import (DESTRUCTIVE_FAULTS, FAULT_KINDS,
                                  FaultInjector, FaultPlan, FaultyEndpoint)

__all__ = ["Clock", "DESTRUCTIVE_FAULTS", "FAULT_KINDS", "FaultInjector",
           "FaultPlan", "FaultyEndpoint", "SYSTEM_CLOCK", "SystemClock",
           "VirtualClock"]
