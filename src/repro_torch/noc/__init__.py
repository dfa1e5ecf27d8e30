"""Flit-level NoC simulation on torch: simulator, campaign engine and
the quasi-static control plane."""

from .simconfig import Algo, SimConfig, SimResult
from .sim import run_sim, run_sweep, run_trace, run_trace_sweep
from .watchdog import WD_KEYS, WatchdogReport
from .workload import clos_leaf_trace
from .campaign import (CampaignExecutor, CampaignPoint, CampaignResult,
                       CampaignSpec, CellKey, CellOutcome, campaign_cells,
                       run_campaign)
from .ctrl import (ControlledResult, DriftDetector, LinkFail, LinkRecover,
                   Replan, ReplanConfig, Scenario, TrafficDrift,
                   TrafficEstimator, run_controlled)

__all__ = ["Algo", "SimConfig", "SimResult", "run_sim", "run_sweep",
           "run_trace", "run_trace_sweep", "clos_leaf_trace",
           "CampaignSpec", "CampaignPoint", "CampaignResult",
           "run_campaign", "CampaignExecutor", "CellKey", "CellOutcome",
           "campaign_cells", "LinkFail", "LinkRecover", "TrafficDrift",
           "Scenario", "TrafficEstimator", "DriftDetector", "ReplanConfig",
           "Replan", "ControlledResult", "run_controlled", "WD_KEYS",
           "WatchdogReport"]
