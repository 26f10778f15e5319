"""Runtime policies of training: failure detection, elastic replanning and
straggler mitigation (a port of ``repro/runtime``)."""
from .fault import FailureDetector, FaultConfig
from .elastic import plan_mesh_shape, ElasticPlan, build_mesh, plan_elastic
from .straggler import StragglerPolicy, StragglerReport

__all__ = [
    "FailureDetector",
    "FaultConfig",
    "plan_mesh_shape",
    "ElasticPlan",
    "build_mesh",
    "plan_elastic",
    "StragglerPolicy",
    "StragglerReport",
]
