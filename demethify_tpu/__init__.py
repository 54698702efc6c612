"""DeMethify-TPU: methylation deconvolution on JAX accelerators.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of
cortes-ciriano-lab/DeMethify (reference: /root/reference): weighted,
constrained non-negative matrix factorization for estimating cell-type
proportions (and unknown cell-type methylation profiles) from bulk
methylation data.

Four solver modes (reference `demethify/demethify.py:148-217`):
  - reference-based      (supervised weighted NNLS per sample)
  - partial-reference    (FISTA block-coordinate descent, unknown profiles)
  - purity-constrained   (Frank-Wolfe over purity-scaled simplexes)
  - unsupervised         (weighted NMF with the same FISTA machinery)

Everything on the compute path is pure-functional JAX, jitted end-to-end,
sharded over a ('replicate', 'cpg') device mesh, with one Pallas (Triton
route) kernel per small-tensor inner loop on the GPU (ops/pallas_small.py).
"""

__version__ = "0.1.0"

from demethify_tpu.solvers.api import (  # noqa: F401
    DeconvolutionResult,
    deconvolve,
    partial_reference_deconv,
    purity_deconv,
    supervised_deconv,
    unsupervised_deconv,
)
from demethify_tpu.selection.sweep import evaluate_best_ic  # noqa: F401
from demethify_tpu.uncertainty.bootstrap import bootstrap_ci  # noqa: F401
from demethify_tpu.io.readers import Dataset, load_dataset  # noqa: F401
from demethify_tpu.checkpoint import load_factors, save_factors  # noqa: F401
