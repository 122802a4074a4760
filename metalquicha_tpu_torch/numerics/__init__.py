from .finite_differences import displaced_geometries, hessian_from_gradients  # noqa: F401
from .vibrational import compute_vibrational_analysis  # noqa: F401
from .thermochemistry import compute_thermochemistry  # noqa: F401
