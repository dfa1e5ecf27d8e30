"""Q-StaR core on the host (numpy) and the device planner (torch)."""

from .topology import (Topology, mesh2d, mesh2d_edge_io, torus, multipod,
                       cmesh, express_mesh, fault_region_mesh)
from . import traffic
from .nrank import NRankResult, nrank, nrank_channel, possibility_weights
from .bidor import BiDORTable, bidor, bidor_k, dor_table
from .qstar import (QStarPlan, build_plan, predicted_node_load, link_load,
                    link_load_stats)
from .plan_fast import (build_plan_fast, build_plans_batched, gate_plan,
                        joint_possibility_fast)
from .routes import dimension_orders, route_nodes, next_port_table
from .certify import (Certificate, CertificationError, apply_repair,
                      build_cdg, certify_ports, certify_table,
                      cyclic_scc_nodes, has_cycle_bruteforce)

__all__ = [
    "Topology", "mesh2d", "mesh2d_edge_io", "torus", "multipod",
    "cmesh", "express_mesh", "fault_region_mesh", "traffic",
    "NRankResult", "nrank", "nrank_channel", "possibility_weights",
    "BiDORTable", "bidor", "bidor_k", "dor_table",
    "QStarPlan", "build_plan", "predicted_node_load", "link_load",
    "link_load_stats", "build_plan_fast", "build_plans_batched",
    "gate_plan", "joint_possibility_fast",
    "dimension_orders", "route_nodes", "next_port_table",
    "Certificate", "CertificationError", "apply_repair", "build_cdg",
    "certify_ports", "certify_table", "cyclic_scc_nodes",
    "has_cycle_bruteforce",
]
