"""Declarative scenario layer of the port: specs, the named registry, and
verification against the committed golden traces.

    from repro_torch.scenarios import get_scenario

    eng = get_scenario("dcasgd").build(device="cuda")
    hist = eng.run()
"""
from repro_torch.async_engine.faults import (       # noqa: F401
    FaultSpec, PartitionSpec,
)
from repro_torch.scenarios.spec import (            # noqa: F401
    ElasticSpec, FailureSpec, Scenario,
)
from repro_torch.scenarios.registry import (        # noqa: F401
    all_scenarios, get_scenario, names, register,
)
