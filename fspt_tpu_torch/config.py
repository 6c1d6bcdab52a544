"""Configuration dataclasses.

The reference configures its kernels three ways (reference main.js:953-975 URL
params, scene JSON, and #define injection main.js:873-877).  Here all of that
collapses into frozen dataclasses: fields that specialize compiled code are
static jit args (changing them triggers recompilation, the moral equivalent of
the reference's shader-preprocessor splice), fields that are runtime-tunable
(exposure, saturation, ...) are traced device scalars.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Camera state. Mirrors reference camera.fs uniforms + main.js DOM state.

    fov_scale: half-width of the image plane at unit distance
        (reference main.js:69 `fovScale`, default 0.5).
    focal_depth / aperture: thin-lens DOF (reference camera.fs:32-35;
        lensFeatures.x = 1 - 1/focalDepth encoding happens inside raygen).
    """

    position: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    direction: Tuple[float, float, float] = (0.0, 0.0, -1.0)
    fov_scale: float = 0.5
    focal_depth: float = 1e6
    aperture: float = 0.0


@dataclasses.dataclass(frozen=True)
class PostConfig:
    """Post-process chain settings (reference shader/draw.fs uniforms)."""

    exposure: float = 1.0
    saturation: float = 1.0
    denoise: bool = False          # firefly sigma-clamp filter on/off
    max_sigma: float = 2.0         # reference main.js:73 `sigma` slider default
    gamma: float = 2.2


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render configuration.

    Everything here is a static argument of the jitted render step — the
    TPU-native replacement for the reference's #define injection
    (reference main.js:873-877) and const shader parameters.
    """

    width: int = 512
    height: int = 512
    bounces: int = 4               # reference shader/tracer.fs:9 NUM_BOUNCES
    # Refraction does not consume a bounce in the reference (tracer.fs:488
    # `i--`).  We run a static loop of `max_iters` segments with a per-lane
    # bounce budget; extra segments cover refraction chains.
    extra_refraction_iters: int = 4
    batch_spp: int = 1             # samples per jitted step
    # (the sample cap, BVH leaf size and env-bin cap are *scene* properties:
    # Scene.samples / Scene.leaf_size / load_scene's env_bins_cap)
    radiance_clamp: float = 1024.0 # reference tracer.fs:515
    emissive_scale: float = 30.0   # hardcoded ×30 (reference tracer.fs:467)
    max_t: float = 1.0e5           # reference tracer.fs:10 MAX_T
    epsilon: float = 1.0e-6        # reference tracer.fs:11 EPSILON
    stack_depth: int = 64          # traversal stack bound (tracer.fs:368)
    # Engine selection for intersection:
    #   "split"  - Pallas phase-split multiwalk kernel (ops/traverse4.py):
    #              node-descent and leaf-MT substeps run in separate
    #              bursts so each serial visit pays only its own vector
    #              code path (~uses traverse3 automatically for scenes
    #              whose tables exceed VMEM)
    #   "walk"   - Pallas multiwalk kernel (ops/traverse3.py): 8 vectorized
    #              128-ray walks per program, fused node+leaf substeps
    #   "packet" - Pallas 1024-ray packet kernel (ops/traverse.py)
    #   "brute"  - O(N*T) oracle, tests only
    intersector: str = "walk"
    # Sort secondary rays by direction octant before traversal so packets
    # stay coherent (stable sort preserves tile grouping within octants)
    sort_rays: bool = True
    # Coherence-sort the PATH STATE once per iteration (Morton order of
    # hit points) instead of sorting + un-permuting every traversal
    # launch: hits come back aligned, so the inverse row scatter
    # (measured 10-36 ms at 403k lanes — the dominant sort-phase cost,
    # PERF.md) disappears, and only w lanes are sorted instead of the
    # 2w-3w launch concatenation.  Estimator-neutral (lane order never
    # enters the estimator).  Off by default, on in bench/CLI.
    sort_state: bool = False
    # Active-lane compaction (core/integrator._compact): statically shrink
    # the path state between bounce iterations, Russian-roulette-reweighting
    # when live lanes exceed the next width, so per-iteration cost tracks
    # occupancy instead of staying O(n_pixels) for all max_iters.  Unbiased;
    # sample-exact to the uncompacted estimator whenever occupancy stays
    # under the schedule (all per-lane RNG is keyed by global lane id).
    # Default off so estimator-parity tests and goldens are untouched;
    # bench.py / the CLI / the viewer turn it on.
    compact: bool = False
    # Width divisor per bounce iteration (last entry repeats): iteration i
    # runs at ceil(n / compact_schedule[i]) lanes (rounded up to a 1024
    # packet).  Divisors may be fractional.  The default tracks the
    # measured bunny-bench occupancy collapse (primary hit rate 0.68,
    # then 0.10, 0.04, <=0.01): bounce 0 sheds the 24% of lanes whose
    # primary ray missed.  Schedules tighter than occupancy stay unbiased
    # (RR reweighting) but raise tail-bounce variance; the default keeps
    # RR rare even for closed scenes.  The v5e bunny sweep measured
    # (1.3, 8, 32, 64) at 4.71 Mrays/s vs this default's 4.44 with 99.2%
    # of segments surviving — open/sky scenes should pass the tighter
    # schedule explicitly (bench.py does).
    compact_schedule: Tuple[float, ...] = (1.3, 4, 16, 32)
    # Cross-sample wavefront batching: trace all batch_spp samples of a
    # step as ONE path state (core/integrator.trace_paths_batched) so the
    # samples' compacted tails pool into shared packet-aligned launches —
    # the 1024-lane width floor that kept tail iterations at ~0% occupancy
    # amortizes over the batch.  Requires compact=True and batch_spp > 1 to
    # have any effect; pair with a tail-tightened compact_schedule (the
    # divisors apply to batch_spp * num_pixels lanes).  Off by default for
    # estimator-parity defaults, like compact.
    wavefront_batch: bool = False
    # Iterations whose PER-SAMPLE launch width exceeds this stay per-sample
    # (merging early high-occupancy iterations only superlinearizes the
    # coherence sorts); at the first schedule group at or below it, the
    # batch's states concatenate into one shared wavefront.
    wavefront_merge_width: int = 65536
    # Pack the four material maps (+x-neighbor texels) into one combined
    # row table per traced sample so a full bilinear material fetch costs
    # 2 gathers instead of 16 (core/integrator.TexTables).  Automatically
    # falls back to per-map fetches when the combined table would exceed
    # the in-module memory guard.
    packed_textures: bool = True
    # Shading-gather fusion (round-5; PERF.md lever 1).  TPU gather cost is
    # per-index, and env lookups are 4 of the ~8 row gathers each shading
    # iteration pays:
    #   nee_env_nearest    — fetch the NEE radiance at the very texel the
    #       bin sampler drew (one gather, fused into the sample; no
    #       direction->equirect inverse) instead of bilinear at the
    #       reconstructed direction (two gathers).  A consistent MC
    #       estimator either way (radiance evaluated where the pdf lives);
    #       default off for bilinear parity with the reference
    #       (tracer.fs:504), on in bench/CLI.
    #   escape_env_nearest — nearest-texel env radiance for scatter-ray
    #       escapes (one gather vs two).  Secondary-bounce escapes land on
    #       rough-path carriers where filtering is visually irrelevant;
    #       primary-miss backgrounds (the visible sky) stay bilinear
    #       unconditionally.
    nee_env_nearest: bool = False
    escape_env_nearest: bool = False
    # Trace occlusion rays (env + light NEE shadows) in their own any-hit
    # launch instead of batching them into the nearest-hit scatter launch.
    # Measured on v5e (bunny bench): does NOT pay — 4.25 vs 4.30 Mrays/s
    # and 2x the compile time (an extra any-hit kernel specialization per
    # compaction width); the coherence sort already condenses parked lanes
    # so the batched launch wastes little.  Kept as an off-by-default knob
    # for scenes with much higher shadow-ray ratios (light NEE heavy).
    split_shadow: bool = False
    # Area-light next-event estimation with MIS.  The reference shipped this
    # broken and disabled (dead lightTex/numLights uniforms, tracer.fs:18,27;
    # README.md:33 "Light sampling is currently broken"); here it works.
    # Default off for estimator parity with the reference.
    use_light_nee: bool = False
    # debug modes: "render" | "bvh_heatmap" (reference mode=test, bvh_test.fs)
    mode: str = "render"
    heatmap_scale: float = 0.001   # reference bvh_test.fs:229
    seed: int = 0

    @property
    def max_iters(self) -> int:
        return self.bounces + self.extra_refraction_iters

    @property
    def num_pixels(self) -> int:
        return self.width * self.height


def resolution_from_spec(spec: str, window: Tuple[int, int] = (1280, 720)):
    """Parse the reference's `res=` URL grammar: "WxH" | "S" | "Nx"
    (reference main.js:953-964): explicit WxH, square SxS, or window*N."""
    spec = spec.strip()
    if "x" in spec and not spec.endswith("x"):
        w, h = spec.split("x")
        return int(w), int(h)
    if spec.endswith("x"):
        n = float(spec[:-1])
        return int(window[0] * n), int(window[1] * n)
    s = int(spec)
    return s, s
