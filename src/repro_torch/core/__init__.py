from .graph import Graph, OpSpec, TensorSpec
from .tiling import Part, REDUCED, REPLICATE, conversion_cost
from .solver import (MeshAxis, OneCutSolution, TilingSolution,
                     assignment_cost_naive, canonical_mp_assignment,
                     composed_cost, data_parallel_assignment,
                     model_parallel_fixed, solve_mesh, solve_one_cut,
                     solve_one_cut_bruteforce)
from .plan import ShardingPlan, manual_megatron_plan
from . import builders
