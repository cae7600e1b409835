"""Figures (counterpart of ``diffusion_extensions_tpu/viz/``): numpy and
matplotlib only, drawn headless with Agg.  matplotlib is imported inside
the functions that draw, so the package imports where it is absent."""
from .colors import (  # noqa: F401
    BLACK,
    BLACK_F,
    BLUE,
    BLUE_F,
    GREEN,
    GREEN_F,
    GREY,
    GREY_F,
    ORANGE,
    ORANGE_F,
    WHITE,
    WHITE_F,
)
from .mpl import multiple_formatter, setup_pi_axis  # noqa: F401
from .sphere import plot_igso3_density_spheres, plot_rotation_frames  # noqa: F401
