"""Render configuration.

Surfaces every magic constant of the reference as config (SURVEY §7 quirk 8):
shadow epsilon 0.001 (code.cl:659), exposure 1.8 (code.cl:1382), ambient 0.2
(Assign08 code.cl:929), degenerate-AABB inflation 0.1 (code.js:839-840),
fixed bounce count 5 (code.js:1829), spp default (code.js:399-400).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 320
    height: int = 240
    spp: int = 1                  # rays per pixel per pass (perfect square if >1)
    bounces: int = 5              # fixed indirect bounces (ref code.js:1829)
    exposure: float = 1.8         # tonemap scale (ref code.cl:1382)
    shadow_eps: float = 1e-3      # shadow-ray origin offset (ref code.cl:659)
    ambient: float = 0.2          # Assign08 direct-lighting ambient (ref Assign08 code.cl:929)
    two_sided_triangles: bool = False  # ref default single-sided (code.cl:257)
    russian_roulette: bool = False     # extension (BASELINE.json config 5)
    rr_start_depth: int = 2
    normalize_emitter: bool = True     # ref lightRender normalizes irradiance (code.cl:617)
    replicate_stale_poi: bool = False  # bug-compat: re-shade stale POI after escaped bounce
    use_grid: bool = False             # uniform-grid DDA vs brute-force matmul path
    n_slabs: int | tuple = 1           # scene grid resolution (ref code.js:399);
                                       # int = cubic, (nx, ny, nz) = per axis
                                       # ((n, 1, 1) = Assign06 1-D slabs)
    obj_chunk: int = 256               # objects per chunk in the brute-force
                                       # champion scan
    seed: int = 1234

    @property
    def n_pixels(self) -> int:
        return self.width * self.height

    @property
    def total_rays(self) -> int:
        return self.width * self.height * self.spp
