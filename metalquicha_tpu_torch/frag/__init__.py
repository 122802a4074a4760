from .combinatorics import (  # noqa: F401
    binomial,
    enumerate_polymers,
    get_nfrags,
    polymer_levels,
)
from .screening import apply_distance_screening  # noqa: F401
from .mbe import compute_mbe, mbe_weights  # noqa: F401
from .gmbe import enumerate_pie_terms, compute_gmbe_pie  # noqa: F401
