"""deepctr_tpu — a CTR-prediction engine in JAX (the package name is
historical).

A from-scratch JAX/XLA re-design of the capabilities of the reference
repo ``Atomu2014/deep-ctr`` (ECIR'16 "Deep Learning over Multi-field
Categorical Data", arXiv:1601.02376): LR, FM, FNN (FM-initialised DNN) and
SNN (sampling-based NN with DAE/RBM pretraining) over multi-field one-hot
categorical data.

Reference parity map (SURVEY.md §2; the reference mount was empty this
session, so citations are to the survey's component inventory, not file:line):

- C3 data loader / one-hot index utilities -> :mod:`deepctr_tpu.data`
- C4 LR trainer                            -> :mod:`deepctr_tpu.models.lr`
- C5 FM trainer                            -> :mod:`deepctr_tpu.models.fm`
- C6 FNN trainer                           -> :mod:`deepctr_tpu.models.fnn`
- C7/C8 SNN-DAE / SNN-RBM trainers         -> :mod:`deepctr_tpu.models.snn`
- C9 evaluator (AUC/logloss)               -> :mod:`deepctr_tpu.utils.metrics`
- C10 sparse-update machinery              -> :mod:`deepctr_tpu.optim.sparse`
                                              + :mod:`deepctr_tpu.ops.scatter`

Additions beyond the reference:

- mesh parallelism (DP + row-sharded embedding tables with all-to-all)
                                           -> :mod:`deepctr_tpu.parallel`
- streaming host feature pipeline          -> :mod:`deepctr_tpu.data.pipeline`
- checkpoint / FM->FNN init handoff        -> :mod:`deepctr_tpu.utils.checkpoint`
"""

__version__ = "0.1.0"
