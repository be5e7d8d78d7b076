"""Request-level traffic (port of ``repro.traffic``): seeded open-loop
workloads (:mod:`~repro_torch.traffic.workloads`), replayable fault
schedules with Kalman-bank straggler detection
(:mod:`~repro_torch.traffic.faults`), the session gateway that
multiplexes many sessions onto one engine's lanes through session paging,
EDF admission and checkpointed resume (:mod:`~repro_torch.traffic.gateway`),
its round clock on the device, one CUDA graph a chunk of rounds
(:mod:`~repro_torch.traffic.megatick`), and the offered-load sweep
(:mod:`~repro_torch.traffic.loadsweep`).
"""

from repro_torch.traffic.faults import (FAULT_KINDS, Brownout, DeviceLoss,
                                        DVFSDrift, FaultSchedule,
                                        KalmanLaneDetector, LaneStraggler,
                                        scenario)
from repro_torch.traffic.gateway import GatewayResult, SessionGateway
from repro_torch.traffic.loadsweep import (app_only_table,
                                           hindsight_static_config,
                                           sweep_loads, sys_only_table)
from repro_torch.traffic.megatick import MegatickGateway
from repro_torch.traffic.workloads import (ArrivalProcess, DiurnalProcess,
                                           FlashCrowdProcess, MMPPProcess,
                                           PoissonProcess, Session,
                                           TenantSpec, TrafficRequest,
                                           build_sessions,
                                           generate_requests)

__all__ = [
    "ArrivalProcess", "PoissonProcess", "MMPPProcess", "DiurnalProcess",
    "FlashCrowdProcess", "TenantSpec", "Session", "TrafficRequest",
    "build_sessions", "generate_requests", "SessionGateway",
    "GatewayResult", "MegatickGateway", "hindsight_static_config",
    "sweep_loads", "app_only_table", "sys_only_table", "FaultSchedule", "LaneStraggler", "DeviceLoss",
    "DVFSDrift", "Brownout", "KalmanLaneDetector", "scenario",
    "FAULT_KINDS",
]
