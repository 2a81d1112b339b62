"""Render settings, with the fields and defaults of
capsaicin_tpu/render/settings.py:
  - RenderOptions: the variant switches (HLSL #defines in the reference,
    raytracing_system.h:22-27)
  - Settings: the runtime knobs (SettingsComponent, gui_system.h:20-40), as
    host floats rounded to float32, so a kernel takes them as arguments
    and the frame never reads a value back from the device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

# Output modes (OutputType, gui_system.h:11-17)
OUTPUT_COMBINED = 0
OUTPUT_DIRECT = 1
OUTPUT_INDIRECT = 2
OUTPUT_VARIANCE = 3


@dataclasses.dataclass(frozen=True)
class RenderOptions:
    """Variant switches; defaults match RaytracingOptions{false, true, true}
    (raytracing_system.h:22-27) and the SettingsComponent bools. The EAW
    storage variants default to "0"/False here and are not read from the
    environment."""

    lowres_indirect: bool = False
    use_variance: bool = True
    gbuffer_feedback: bool = True
    denoise: bool = True
    gather: bool = True
    eaw5: bool = True
    taa: bool = True
    num_diffuse_bounces: int = 1
    spp: int = 1
    output: int = OUTPUT_COMBINED
    sort_bounce_rays: bool = True
    use_material_kd: bool = False
    history_dtype: str = "float32"
    eaw_fused: str = "0"
    eaw_bf16: bool = False

    def __post_init__(self):
        if self.eaw_fused not in ("0", "1", "13"):
            raise ValueError(f"eaw_fused={self.eaw_fused!r}: expected '0'/'1'/'13'")
        if not isinstance(self.eaw_bf16, bool):
            raise ValueError(f"eaw_bf16={self.eaw_bf16!r}: expected bool")


class Settings(NamedTuple):
    """Runtime knobs; defaults from gui_system.h:25-37."""

    eaw_normal_sigma: float
    eaw_depth_sigma: float
    eaw_luma_sigma: float
    gather_normal_sigma: float
    gather_depth_sigma: float
    gather_luma_sigma: float
    temporal_upscale_feedback: float
    taa_feedback: float
    exposure: float  # display-only scale before gamma (1.0 == the reference)


def make_settings(**values) -> Settings:
    """Settings with every value rounded to float32, as the JAX package
    holds them."""
    return Settings(**{k: float(np.float32(v)) for k, v in values.items()})


def default_settings() -> Settings:
    return make_settings(
        eaw_normal_sigma=128.0,
        eaw_depth_sigma=3.0,
        eaw_luma_sigma=3.0,
        gather_normal_sigma=64.0,
        gather_depth_sigma=2.0,
        gather_luma_sigma=3.0,
        temporal_upscale_feedback=0.975,
        taa_feedback=0.9,
        exposure=1.0,
    )
