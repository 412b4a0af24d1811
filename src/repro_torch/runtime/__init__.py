from .supervisor import (
    Failure, ProcessEvent, ProcessSupervisor, RunResult, SupervisorConfig, run_supervised,
    straggler_report,
)
