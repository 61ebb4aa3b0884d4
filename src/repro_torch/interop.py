"""Carry `repro`'s state across into the port.

`load_problem` builds the port's `BilevelProblem` from the data arrays
of a `repro` problem (as numpy), so a run can start from the JAX
package's exact instance; `solve(..., x0=, y0=)` takes numpy arrays for
the iterates.  Together they let both packages run on identical inputs
without depending on either's random generators:

    from repro.core.problems import ho_regression
    jprob = ho_regression(8, 16)
    tprob = load_problem("ho_regression",
                         {k: np.asarray(v) for k, v in jprob.data.items()},
                         device="cpu")

This module imports nothing of `repro`; the caller converts.
"""
from __future__ import annotations

import numpy as np

from .core.problems import FAMILY_FROM_DATA, BilevelProblem


def load_problem(family: str, data: dict, *, device=None,
                 **family_kwargs) -> BilevelProblem:
    """The port's `family` problem on `data` ({name: array}, leading
    agent axis), on `device` (CUDA unless named).

    family_kwargs are the family's non-data settings: quadratic
    (mu_g, mu_f), ho_svm (smooth), ho_softmax (n_classes),
    hyper_representation (hidden, n_classes, ridge), fair_loss_tuning
    (n_classes, ridge)."""
    try:
        build = FAMILY_FROM_DATA[family]
    except KeyError:
        raise KeyError(f"unknown problem family {family!r}; expected one "
                       f"of {sorted(FAMILY_FROM_DATA)}") from None
    arrays = {k: np.asarray(v) for k, v in data.items()}
    return build(arrays, device=device, **family_kwargs)
