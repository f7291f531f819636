"""Core: the paper's contribution — MIG workload placement optimization.
The port's copy of ``repro/core`` (pure Python and numpy; no module here
imports torch), holding what the cluster server reaches:

    profiles     — Table-1 device/profile geometry (A100, H100 80GB/96GB)
    tpu_profiles — TPU pod-partition adaptation (the reference's default)
    state        — Workload / Placement / GPUState / ClusterState
    preprocess   — Algorithm 1 (free partitions P_g)
    indexing     — bin-level solution -> concrete slice indexes
    wpm_mip      — the WPM mixed-integer program (Eqns 2a-2k)
    heuristic    — Sec-4.2 rule-based placement (3 use cases)
    baselines    — first-fit / load-balanced schedulers
    patterns     — beyond-paper pattern-enumeration exact solver
    metrics      — Table-3 evaluation metrics
    migration    — migration planning, pricing and commit policies
    engine       — PlacementEngine: all approaches behind one interface
    fabric       — vectorized fleet-scale feasibility/scoring (numpy)
    traffic      — seeded request-arrival generators (demand axis)
    perfmodel    — per-partition service rates (prefill/decode tokens/s)
    autoscaler   — SLO-aware replica controller (offered load -> targets)

The reference's event simulators, fault injector and fleet generator
(``events``, ``faults``, ``fleetgen``, ``simulator``) are not copied yet.
"""
from .autoscaler import SLO, Autoscaler, AutoscalerConfig  # noqa: F401
from .engine import EngineResult, PlacementEngine, available_policies  # noqa: F401
from .perfmodel import PerfModel  # noqa: F401
from .profiles import A100_80GB, H100_80GB, H100_96GB, DeviceModel, Profile  # noqa: F401
from .state import (  # noqa: F401
    HEALTH_STATES,
    ClusterState,
    GPUState,
    Placement,
    Transaction,
    Workload,
)
from .tpu_profiles import TPU_V5E_POD, profile_for_chips  # noqa: F401
from .traffic import ModelTraffic, RequestTrace, generate_requests  # noqa: F401
