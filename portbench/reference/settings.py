"""The frame's options and settings, as the configuration files state
them: a frozen copy of the fields of capsaicin_tpu_torch/render/settings.py
(RaytracingOptions and the SettingsComponent of the reference,
raytracing_system.h:22-27, gui_system.h:25-37), with no default read from
the environment.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

OUTPUT_COMBINED = 0
OUTPUT_DIRECT = 1
OUTPUT_INDIRECT = 2
OUTPUT_VARIANCE = 3


@dataclasses.dataclass(frozen=True)
class RenderOptions:
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
    use_material_kd: bool = False


class Settings(NamedTuple):
    eaw_normal_sigma: float
    eaw_depth_sigma: float
    eaw_luma_sigma: float
    gather_normal_sigma: float
    gather_depth_sigma: float
    gather_luma_sigma: float
    temporal_upscale_feedback: float
    taa_feedback: float
    exposure: float


def make_settings(**values) -> Settings:
    """Settings with every value rounded to float32."""
    return Settings(**{k: float(np.float32(v)) for k, v in values.items()})


def options_from(values: dict) -> RenderOptions:
    """The reference's options from a configuration's option values; keys
    that only choose how the program computes (its storage types, fusions
    and ray order) do not change what the reference computes."""
    fields = {f.name for f in dataclasses.fields(RenderOptions)}
    return RenderOptions(**{k: v for k, v in values.items() if k in fields})
