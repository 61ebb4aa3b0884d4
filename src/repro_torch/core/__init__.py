"""repro_torch.core — bilevel problems and the DAGM algorithm stack.

  * `problems` — `BilevelProblem` on `torch.func` + the problem zoo,
  * `penalty`  — penalized reformulation, inner DGD step (Eq. 15–16),
  * `dihgp`    — Algorithm 1, dense (Cholesky) and matrix-free tiers,
  * `dagm`     — Algorithm 2: `dagm_init_carry` / `dagm_run_chunk`,
  * `baselines` — DGBO, DGTBO, FedNest and MA-DBO (`solve(method=...)`),
  * `jobs`     — DAGM rounds on a serve bucket's job axis.
"""
from .baselines import BASELINE_SOLVERS
from .dagm import (RoundHP, dagm_init_carry, dagm_outer_step_c,
                   dagm_run_chunk, default_metrics, hypergrad_estimate_c)
from .problems import (PROBLEM_FAMILIES, BilevelProblem, fair_loss_tuning,
                       ho_logistic, ho_regression, ho_softmax, ho_svm,
                       hyper_representation, quadratic_bilevel)

__all__ = [
    "BASELINE_SOLVERS", "BilevelProblem", "PROBLEM_FAMILIES", "RoundHP",
    "dagm_init_carry", "dagm_outer_step_c", "dagm_run_chunk", "default_metrics",
    "fair_loss_tuning", "ho_logistic", "ho_regression", "ho_softmax",
    "ho_svm", "hyper_representation", "hypergrad_estimate_c",
    "quadratic_bilevel",
]
