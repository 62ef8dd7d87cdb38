"""Layer A: analytical silicon-photonic 2.5D interposer + accelerator models
(the paper's own evaluation methodology), the PyTorch port of the JAX
package's `core`.  The scalar golden path is host numpy; the columnar,
batched and streaming engines run in float64 on a device (``device=``,
default "cuda").  The Pareto and co-design searches (`core.search`) find
the frontier of a design grid and refine its points by gradient and
trust-region descent; the fabric layer (`core.fabric`) turns a
design point, or a whole frontier, into the link numbers the batcher and
the trainer plan against."""

from repro_torch.core.devices import (
    DeviceLibrary,
    DEFAULT_DEVICES,
    laser_electrical_power_w,
    db_to_linear,
    linear_to_db,
)
from repro_torch.core.topology import (
    NetworkParams,
    NetworkModel,
    sprint_bus,
    spacx_bus,
    tree_network,
    trine_network,
    electrical_mesh,
    TOPOLOGIES,
)
from repro_torch.core.power import Traffic, NetworkReport, evaluate_network
from repro_torch.core.planner import (
    choose_subnetworks,
    plan_gateway_activation,
    plan_collective_channels,
)
from repro_torch.core.workloads import Workload, Layer, CNN_WORKLOADS, gemm_workload
from repro_torch.core.accelerator import (
    AcceleratorConfig,
    ChipletSpec,
    AccelReport,
    monolithic_crosslight,
    crosslight_25d_siph,
    crosslight_25d_elec,
    evaluate_accelerator,
    evaluate_accelerator_batch,
    evaluate_accelerator_grid,
)
# NOTE: the `sweep` *function* is deliberately not re-exported here — it
# would shadow the `repro_torch.core.sweep` submodule attribute on the
# package.  Use `from repro_torch.core.sweep import sweep`.
from repro_torch.core.sweep import (
    GridSpec,
    SweepGrid,
    SweepResult,
    build_grid,
    grid_spec,
    network_columns,
    evaluate_columns,
    sweep_chunked,
    sweep_scalar_reference,
)
from repro_torch.core.faults import (
    FaultModel,
    FaultScenario,
    FabricUnusableError,
    HEALTHY,
    AvailabilityReducer,
    availability_search,
    degraded_network_columns,
    evaluate_degraded,
    faulted_columns_fn,
)
from repro_torch.core.fabric import (
    Fabric,
    DEFAULT_FABRIC,
    FABRIC_PRESETS,
    fabrics_from_front,
    get_fabric,
    metallic_ici,
    degrade,
    overlapped_step_s,
)
# `pareto_search`/`codesign_pareto` are the one-call entry points; the rest
# of the toolkit lives in `repro_torch.core.search`.
from repro_torch.core.search import (
    ParetoFront,
    codesign_pareto,
    frontier_configs,
    pareto_front,
    pareto_mask,
    pareto_search,
    refine_continuous,
    refine_codesign,
    refine_front,
    refine_trust_region,
    DEFAULT_REFINE_AXES,
    ACCEL_REFINE_AXES,
)

__all__ = [n for n in dir() if not n.startswith("_")]
