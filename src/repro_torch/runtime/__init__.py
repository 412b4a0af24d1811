from .elastic import ElasticPlan, make_elastic_mesh, plan_remesh, remesh
from .supervisor import (
    Failure, ProcessEvent, ProcessSupervisor, RunResult, SupervisorConfig, run_supervised,
    straggler_report,
)
