"""repro_torch.core — bilevel problems and the DAGM algorithm stack.

  * `problems` — `BilevelProblem` on `torch.func` + the problem zoo and
                 the paper's accuracies (`hyperrep_accuracy`,
                 `balanced_accuracy`),
  * `penalty`  — penalized reformulation, inner DGD step (Eq. 15–16),
  * `dihgp`    — Algorithm 1, dense (Cholesky) and matrix-free tiers,
  * `dagm`     — Algorithm 2: `dagm_init_carry` / `dagm_run_chunk`,
  * `baselines` — DGBO, DGTBO, FedNest and MA-DBO (`solve(method=...)`),
  * `jobs`     — DAGM rounds on a serve bucket's job axis.
"""
from .baselines import BASELINE_SOLVERS
from .dagm import (RoundHP, dagm_comm_bytes, dagm_init_carry,
                   dagm_outer_step_c, dagm_run_chunk, default_metrics,
                   hypergrad_estimate_c)
from .problems import (PROBLEM_FAMILIES, BilevelProblem, balanced_accuracy,
                       fair_loss_tuning, ho_logistic, ho_regression,
                       ho_softmax, ho_svm, hyper_representation,
                       hyperrep_accuracy, quadratic_bilevel)

__all__ = [
    "BASELINE_SOLVERS", "BilevelProblem", "PROBLEM_FAMILIES", "RoundHP",
    "balanced_accuracy", "dagm_comm_bytes", "dagm_init_carry",
    "dagm_outer_step_c", "dagm_run_chunk", "default_metrics",
    "fair_loss_tuning", "ho_logistic", "ho_regression", "ho_softmax",
    "ho_svm", "hyper_representation", "hypergrad_estimate_c",
    "hyperrep_accuracy", "quadratic_bilevel",
]
