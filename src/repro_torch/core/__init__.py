"""Control plane of the port: the cost model, the placement shim and the
layered planner, the pipeline simulator and the privacy metrics (copies of
``repro/core``; the metrics run on tensors)."""
from .cost_model import (DeviceProfile, LinkProfile, TEE, CPU, GPU,
                         WAN_30MBPS, TPU_POD, TPU_POD_TRUSTED, DCN_LINK,
                         EPC_BYTES, layer_exec_time, seal_time, transmit_time,
                         paging_factor)
from .placement import (LayerProfile, ResourceGraph, Stage, Placement,
                        Evaluation, enumerate_placements, evaluate, solve,
                        profiles_from_cnn, profiles_from_arch)
from .planner import (BeamSolver, CostTables, DPSolver, ExhaustiveSolver,
                      PlacementProblem, SolveResult, Solver, get_solver)
from .planner import solve as planner_solve
from .pipeline_sim import simulate_pipeline, closed_form_completion
from .privacy import (RESOLUTION_DELTA, LM_SIM_DELTA, resolution_private,
                      resolution_similarity, pearson, ssim,
                      downsample_similarity, lm_similarity_profile,
                      private_depth, cut_exposure)
