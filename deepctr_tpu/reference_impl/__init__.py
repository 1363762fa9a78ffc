"""NumPy-faithful reproduction of the reference's training procedure.

SURVEY.md §0 re-verification protocol: the reference mount was empty, so
AUC/logloss parity targets "must be established by reproducing the
reference yourself ... NumPy reimplementation of LR/FM/FNN".  This package
is that reproduction — plain NumPy, minibatch SGD with per-row sparse
updates, matching the functional spec of SURVEY.md §2.3 — and doubles as
the measured throughput baseline for bench.py (the reference published no
perf numbers; BASELINE.json:13 "published": {}).

It deliberately mirrors the REFERENCE design (host-driven per-batch loop,
dense NumPy math), not this engine's design, so comparisons are meaningful.
"""

from .numpy_ref import NumpyFM, NumpyFNN, NumpyLR, train_numpy_model
from .numpy_snn import NumpyDae, NumpyRbm, NumpySnn

__all__ = [
    "NumpyDae",
    "NumpyFM",
    "NumpyFNN",
    "NumpyLR",
    "NumpyRbm",
    "NumpySnn",
    "train_numpy_model",
]
