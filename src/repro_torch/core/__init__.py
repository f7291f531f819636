"""Core: the paper's contribution — MIG workload placement optimization.
The port's copy of ``repro/core``.  Every module is pure Python and numpy
except ``fabric``, whose batched sweeps run as torch ops on ``"cuda"`` by
default (the reference jits them with JAX), or in numpy when asked:

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
    simulator    — Sec-5.1 random test-case generation
    fleetgen     — shared (possibly heterogeneous) fleet construction
    engine       — PlacementEngine: all approaches behind one interface
    events       — event-driven online and demand simulation over traces
    fabric       — vectorized fleet-scale feasibility/scoring (torch on a
                   device, cuda by default; numpy when asked)
    traffic      — seeded request-arrival generators (demand axis)
    perfmodel    — per-partition service rates (prefill/decode tokens/s)
    autoscaler   — SLO-aware replica controller (offered load -> targets)
    faults       — seeded fault injection (GPU/slice failures, drains)
"""
from .autoscaler import SLO, Autoscaler, AutoscalerConfig  # noqa: F401
from .engine import EngineResult, PlacementEngine, available_policies  # noqa: F401
from .events import (  # noqa: F401
    DemandSimulator,
    ModelServiceSpec,
    OnlineSimulator,
    TraceStats,
    generate_trace,
)
from .faults import FaultEvent, FaultInjector, FaultSpec  # noqa: F401
from .fleetgen import build_fleet  # noqa: F401
from .perfmodel import PerfModel  # noqa: F401
from .profiles import A100_80GB, H100_80GB, H100_96GB, DeviceModel, Profile  # noqa: F401
from .simulator import generate_test_case, random_workloads  # noqa: F401
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
