from repro_torch.runtime.fault_tolerance import (  # noqa: F401
    FaultInjector, Heartbeat, HeartbeatTimeout, ResilientRunner, StepFailure)
