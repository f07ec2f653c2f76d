"""Measured-collective calibration loop (PARAM/nccl-tests style).

Sweep real (or synthetic) ``torch.distributed`` collectives over
log-spaced message sizes, least-squares-fit ``NoCParams`` timing
constants to the measurements, persist the result with provenance next
to the plan store, and feed it back into every ``Arch`` preset via
``calibrated=``.

    harness  -- run_sweep / torch_measure_fn / synthetic_measure_fn
    fitter   -- fit_noc_params: weighted NNLS on the Eq. 1/3/4 model
    overlap  -- fit_overlap: achievable compute-collective overlap from
                concurrent compute+collective sweeps
    persist  -- calibrated_noc.json: save / load / staleness / quarantine
    driver   -- calibrate_once: reuse-or-sweep -> fit -> gate -> persist
    __main__ -- ``python -m repro_torch.calibrate`` CLI

Port of ``repro.calibrate``: the same names, with ``torch_measure_fn``
(NCCL on the cards, gloo on CPU ranks) in place of ``jax_measure_fn``.
"""
from .driver import calibrate_once
from .fitter import FitResult, TypeFit, fit_noc_params, predicted_seconds, \
    relative_errors
from .harness import (CALIBRATED_TYPES, MeasuredPoint, SweepConfig,
                      SweepResult, log_sizes, run_sweep,
                      synthetic_measure_fn, torch_measure_fn)
from .overlap import (ConcurrentPoint, OverlapFit, fit_overlap,
                      measured_hidden_fraction, predicted_concurrent_seconds,
                      synthetic_concurrent_points)
from .persist import (CALIB_FILENAME, CALIBRATION_SCHEMA, Calibration,
                      calibration_from_fit, calibration_path,
                      load_calibration, save_calibration)

__all__ = [
    "CALIBRATED_TYPES", "MeasuredPoint", "SweepConfig", "SweepResult",
    "run_sweep", "log_sizes", "torch_measure_fn", "synthetic_measure_fn",
    "FitResult", "TypeFit", "fit_noc_params", "predicted_seconds",
    "relative_errors",
    "ConcurrentPoint", "OverlapFit", "fit_overlap",
    "measured_hidden_fraction", "predicted_concurrent_seconds",
    "synthetic_concurrent_points",
    "CALIBRATION_SCHEMA", "CALIB_FILENAME", "Calibration",
    "calibration_path", "save_calibration", "load_calibration",
    "calibration_from_fit",
    "calibrate_once",
]
