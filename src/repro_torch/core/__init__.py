"""FALKON core: kernels, CG, preconditioner, Nystrom centers, the fit, the
lam path, the host-streamed fits, the mini-batch fits and the baselines."""
from .baselines import KernelPredictor, krr_direct, krr_gradient, nystrom_direct, nystrom_gradient
from .cg import CGResult, active_columns, col_dot, conjugate_gradient, conjugate_gradient_host
from .falkon import (
    FalkonConfig,
    FalkonEstimator,
    FalkonPathResult,
    FalkonPathState,
    FalkonState,
    falkon_fit,
    falkon_fit_minibatch,
    falkon_fit_minibatch_streaming,
    falkon_fit_path,
    falkon_fit_path_streaming,
    falkon_fit_streaming,
    falkon_solve,
    falkon_solve_path,
    falkon_solve_path_streaming,
    falkon_solve_streaming,
    resolve_device,
)
from .kernels import (
    GaussianKernel,
    KernelSpec,
    LaplacianKernel,
    LinearKernel,
    Matern32Kernel,
    PolynomialKernel,
    available_kernels,
    make_kernel,
    spec_of,
    tile_eval,
    tile_transform,
)
from .matvec import (
    cached_knm_apply,
    cached_knm_matvec,
    knm_apply,
    knm_matvec,
    make_knm_cache,
    streaming_knm_apply,
    streaming_knm_matvec,
)
from .minibatch import (
    MinibatchConfig,
    MinibatchResult,
    MinibatchState,
    minibatch_solve,
    minibatch_solve_stream,
)
from .nystrom import (
    LeveragePilot,
    NystromCenters,
    approximate_leverage_scores,
    approximate_leverage_scores_path,
    build_leverage_pilot,
    exact_leverage_scores,
    leverage_score_centers,
    leverage_scores_from_pilot,
    select_centers,
    uniform_centers,
)
from .preconditioner import (Preconditioner, PreconditionerPath, make_preconditioner,
                             make_preconditioner_path)

__all__ = [
    "CGResult", "FalkonConfig", "FalkonEstimator", "FalkonPathResult", "FalkonPathState",
    "FalkonState", "GaussianKernel", "KernelPredictor", "KernelSpec", "LaplacianKernel",
    "LeveragePilot", "LinearKernel", "Matern32Kernel", "MinibatchConfig", "MinibatchResult",
    "MinibatchState", "NystromCenters", "PolynomialKernel",
    "Preconditioner", "PreconditionerPath", "active_columns", "approximate_leverage_scores",
    "approximate_leverage_scores_path", "available_kernels", "build_leverage_pilot",
    "cached_knm_apply", "cached_knm_matvec", "col_dot", "conjugate_gradient",
    "conjugate_gradient_host", "exact_leverage_scores", "falkon_fit", "falkon_fit_minibatch",
    "falkon_fit_minibatch_streaming", "falkon_fit_path",
    "falkon_fit_path_streaming", "falkon_fit_streaming", "falkon_solve", "falkon_solve_path",
    "falkon_solve_path_streaming", "falkon_solve_streaming", "knm_apply", "knm_matvec",
    "krr_direct", "krr_gradient", "leverage_score_centers", "leverage_scores_from_pilot",
    "make_kernel", "make_knm_cache", "make_preconditioner", "make_preconditioner_path",
    "minibatch_solve", "minibatch_solve_stream",
    "nystrom_direct", "nystrom_gradient", "resolve_device", "select_centers", "spec_of",
    "streaming_knm_apply", "streaming_knm_matvec", "tile_eval", "tile_transform",
    "uniform_centers",
]
