from .candidates import SolverConfig, JointProblem, build_problem
from .joint_lp import pdhg_solve, primal_objective, dual_bound, check_feasible
from .bnb import solve_joint
from .milp import exact_solve, solve_joint_milp
