"""Request-level traffic (port of ``repro.traffic``): seeded open-loop
workloads (:mod:`~repro_torch.traffic.workloads`), replayable fault
schedules with Kalman-bank straggler detection
(:mod:`~repro_torch.traffic.faults`), and the session gateway that
multiplexes many sessions onto one engine's lanes through session paging,
EDF admission and checkpointed resume (:mod:`~repro_torch.traffic.gateway`).
"""

from repro_torch.traffic.faults import (FAULT_KINDS, Brownout, DeviceLoss,
                                        DVFSDrift, FaultSchedule,
                                        KalmanLaneDetector, LaneStraggler,
                                        scenario)
from repro_torch.traffic.gateway import GatewayResult, SessionGateway
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
    "GatewayResult", "FaultSchedule", "LaneStraggler", "DeviceLoss",
    "DVFSDrift", "Brownout", "KalmanLaneDetector", "scenario",
    "FAULT_KINDS",
]
