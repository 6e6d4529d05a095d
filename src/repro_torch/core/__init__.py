"""FALKON core: kernels, CG, preconditioner, Nystrom centers and the fit."""
from .cg import CGResult, conjugate_gradient, conjugate_gradient_host
from .falkon import (
    FalkonConfig,
    FalkonEstimator,
    FalkonState,
    falkon_fit,
    falkon_solve,
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
from .nystrom import NystromCenters, select_centers, uniform_centers
from .preconditioner import Preconditioner, make_preconditioner

__all__ = [
    "CGResult", "FalkonConfig", "FalkonEstimator", "FalkonState", "GaussianKernel",
    "KernelSpec", "LaplacianKernel", "LinearKernel", "Matern32Kernel",
    "NystromCenters", "PolynomialKernel", "Preconditioner", "available_kernels",
    "conjugate_gradient", "conjugate_gradient_host", "falkon_fit", "falkon_solve",
    "make_kernel", "make_preconditioner", "resolve_device", "select_centers",
    "spec_of", "tile_eval", "tile_transform", "uniform_centers",
]
