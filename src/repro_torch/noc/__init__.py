"""Flit-level NoC simulation on torch: simulator and campaign engine."""

from .simconfig import Algo, SimConfig, SimResult
from .sim import run_sim, run_sweep
from .campaign import (CampaignExecutor, CampaignPoint, CampaignResult,
                       CampaignSpec, CellKey, CellOutcome, campaign_cells,
                       run_campaign)

__all__ = ["Algo", "SimConfig", "SimResult", "run_sim", "run_sweep",
           "CampaignSpec", "CampaignPoint", "CampaignResult",
           "run_campaign", "CampaignExecutor", "CellKey", "CellOutcome",
           "campaign_cells"]
