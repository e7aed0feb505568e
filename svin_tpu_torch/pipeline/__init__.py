from .programs import (
    BackendStep,
    StepOutput,
    gate_match_all,
    opt_program,
    optimize_marginalize_prune,
    reproj_px_err,
)

__all__ = [
    "BackendStep",
    "StepOutput",
    "gate_match_all",
    "opt_program",
    "optimize_marginalize_prune",
    "reproj_px_err",
]
