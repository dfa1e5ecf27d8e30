"""Flit-level NoC simulation on torch: simulator, campaign engine, the
quasi-static control plane, the campaign service and chaos schedules."""

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
from .service import (CampaignJob, CellCheckpoint, JobStatus,
                      run_campaign_service, spec_fingerprint)
from .chaos import (ChaosConfig, chaos_scenarios, chaos_schedule,
                    hotspot_traffic, region_links)

__all__ = ["Algo", "SimConfig", "SimResult", "run_sim", "run_sweep",
           "run_trace", "run_trace_sweep", "clos_leaf_trace",
           "CampaignSpec", "CampaignPoint", "CampaignResult",
           "run_campaign", "CampaignExecutor", "CellKey", "CellOutcome",
           "campaign_cells", "LinkFail", "LinkRecover", "TrafficDrift",
           "Scenario", "TrafficEstimator", "DriftDetector", "ReplanConfig",
           "Replan", "ControlledResult", "run_controlled", "WD_KEYS",
           "WatchdogReport", "CampaignJob", "CellCheckpoint", "JobStatus",
           "run_campaign_service", "spec_fingerprint", "ChaosConfig",
           "chaos_schedule", "chaos_scenarios", "hotspot_traffic",
           "region_links"]
