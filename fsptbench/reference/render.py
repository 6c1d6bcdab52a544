"""The plain reference of one progressive sample step: the estimator of
upstream FSPT's tracer.fs as the renderer's configuration states it,
written lane by lane over the whole framebuffer.

Every path of every sample of the step is one lane of one wide state;
a lane that ends stays in place, masked.  Nothing is sorted, packed or
batched into shared launches: only the lanes still alive are shaded and
cast each bounce (reference/bvh.py casts them).  What the configuration
makes part of the estimator is kept, because it changes which paths are
followed:

  * the counter-based streams (reference/rng.py): the uniforms of a lane
    are a function of its sample's key and its id within the sample;
  * active-lane compaction's Russian roulette: where a schedule width w
    is smaller than the lanes still alive (A of them), the w with the
    smallest draw of the compaction stream survive, weighted A / w, and
    the rest end with what they gathered.  Without the cross-sample
    wavefront batch each sample's lanes compete among themselves; with
    it, once the per-sample widths fall to the merge width, the samples
    of the step compete as one pool;
  * the radiance clamp per sample, before the samples are summed.

With `use_light_nee` each bounce also samples the scene's area lights
(reference/scene.py lists them), as the renderer's configuration states
its estimator: the bounce's uniform 8 picks a light by the area-weighted
CDF (the first whose CDF value is at least the uniform), uniforms 9 and 10
place a uniform point on it by the square-root warp (barycentrics
1 - sqrt(u9) on corner 1 and u10 sqrt(u9) on corner 2), and an unblocked
shadow segment (to 1e-3 short of the point) adds the sampled lobe's
throughput times the light's emittance over the light's pdf (dist^2 over
|cos| at the light times the total area), weighted by the power heuristic
against the lobe's pdf.  No light is sampled at a dielectric hit or where
the point lies below the surface.  An emitter that a path hits has its
emittance weighted by the power heuristic of the pdf of the ray that made
the hit (1e16 for primary rays; a refraction keeps the pdf of the ray
before it) against the light pdf of that hit.

`lowp=True` stores the path state (rays, hit distance, throughput and
gathered radiance) in bfloat16 after every stage: the control run that the
comparison must reject.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fsptbench.reference import bvh, rng
from fsptbench.reference import shading as sh
from fsptbench.reference.shading import V3, dot, normalize, where

RR_STREAM = 64


def tile_order(width: int, height: int, tile: int = 32) -> np.ndarray:
    """Pixel ids in the order of the framebuffer's lanes: 32 x 32 tiles,
    row-major inside a tile and across tiles."""
    idx = np.arange(width * height, dtype=np.int64).reshape(height, width)
    return np.concatenate([idx[ty:ty + tile, tx:tx + tile].ravel()
                           for ty in range(0, height, tile)
                           for tx in range(0, width, tile)])


def schedule_groups(cfg: dict, n: int):
    """The compaction schedule as (width, iterations) runs: iteration i
    holds ceil(n / divisor_i) lanes rounded up to 1024, never more than
    the iteration before."""
    sched = cfg["compact_schedule"]
    groups, prev = [], n
    for it in range(cfg["max_iters"]):
        w = min(prev, math.ceil(n / sched[min(it, len(sched) - 1)] / 1024)
                * 1024, n)
        if groups and w == groups[-1][0]:
            groups[-1][1] += 1
        else:
            groups.append([w, 1])
        prev = w
    return groups


def merged_plan(cfg: dict, n: int, k: int):
    """The cross-sample batch's plan: per-sample runs while a sample's
    width exceeds the merge width, then runs over the k samples' pooled
    lanes (widths of the pooled schedule)."""
    groups = schedule_groups(cfg, n)
    pooled = schedule_groups(cfg, n * k)
    split = len(groups)
    for gi, (w, _) in enumerate(groups):
        if w <= cfg["wavefront_merge_width"]:
            split = gi
            break
    per_sample = groups[:split]
    its = sum(c for _, c in per_sample)
    merged, itx = [], 0
    for w, count in pooled:
        take = max(0, min(count, itx + count - its))
        if take and itx + count > its:
            merged.append([w, take])
        itx += count
    return per_sample, its, merged


def config(render: dict, seed: int) -> dict:
    """A configuration file's render settings as the reference reads them:
    the run's seed, and the loop's iterations (bounces and the extra
    refraction segments)."""
    cfg = dict(render, seed=seed)
    cfg["max_iters"] = cfg["bounces"] + cfg["extra_refraction_iters"]
    if cfg["mode"] != "render":
        raise NotImplementedError("the plain reference states the render "
                                  "mode only")
    return cfg


class Paths:
    """The wide path state of L = K x n lanes."""

    def __init__(self, origin: V3, direction: V3, k0, k1, lane, sample):
        self.o, self.d = origin, direction
        L = origin.x.shape[0]
        dev = origin.x.device
        z = lambda: torch.zeros(L, dtype=torch.float32, device=dev)
        self.t, self.u, self.v = z(), z(), z()
        self.tri = torch.full((L,), -1, dtype=torch.int64, device=dev)
        self.thr = V3(z() + 1.0, z() + 1.0, z() + 1.0)
        self.color = V3(z(), z(), z())
        self.bounces = torch.zeros(L, dtype=torch.int32, device=dev)
        self.alive = torch.zeros(L, dtype=torch.bool, device=dev)
        # the pdf of the ray that made the current hit (light NEE's MIS)
        self.prev_pdf = torch.full((L,), 1.0e16, dtype=torch.float32,
                                   device=dev)
        self.k0, self.k1, self.lane, self.sample = k0, k1, lane, sample


class Reference:
    """The reference renderer of one scene under one configuration."""

    def __init__(self, scene, cfg: dict, lowp: bool = False):
        self.scene = scene
        self.cfg = cfg
        self.lowp = lowp
        self.tree = bvh.build(scene.v0.cpu().numpy(), scene.e1.cpu().numpy(),
                              scene.e2.cpu().numpy(), scene.v0.device)
        self.max_t = float(cfg.get("max_t", 1.0e5))
        # the parameters a train step differentiates: the environment image
        # and the per-triangle emittance (training sets leaves here)
        self.env = scene.env
        self.emit = scene.attr[:, 33:36]

    # ---- helpers -----------------------------------------------------
    def _q(self, x):
        if self.lowp:
            return x.to(torch.bfloat16).to(torch.float32)
        return x

    def _qv(self, v: V3) -> V3:
        return V3(*(self._q(c) for c in v))

    def _cast(self, o: V3, d: V3, tmax):
        s = self.scene
        return bvh.cast(self.tree, s.v0, s.e1, s.e2, o.stack(), d.stack(),
                        tmax)

    def _fetch(self, layer, u, v) -> V3:
        """Bilinear fetch of atlas layers with REPEAT wrap, v = 0 at the
        image's bottom row."""
        atlas = self.scene.atlas
        r = atlas.shape[1]
        x = u * r - 0.5
        y = (1.0 - v) * r - 0.5
        x0f, y0f = torch.floor(x), torch.floor(y)
        fx = (x - x0f)[:, None]
        fy = (y - y0f)[:, None]
        x0 = torch.remainder(x0f.to(torch.int32), r).long()
        x1 = torch.remainder(x0 + 1, r)
        y0 = torch.remainder(y0f.to(torch.int32), r).long()
        y1 = torch.remainder(y0 + 1, r)
        top = atlas[layer, y0, x0] * (1 - fx) + atlas[layer, y0, x1] * fx
        bot = atlas[layer, y1, x0] * (1 - fx) + atlas[layer, y1, x1] * fx
        return V3.of(top * (1 - fy) + bot * fy)

    # ---- one step ------------------------------------------------------
    @torch.no_grad()
    def step(self, camera: dict, resolution, seed: int, sample_idx: int,
             spp: int):
        """The summed radiance of the `spp` samples of step `sample_idx`,
        (n, 3) in the framebuffer's lane order (tile order)."""
        step_key = rng.fold_in(rng.key(seed), sample_idx)
        return self.trace(camera, resolution,
                          [rng.fold_in(step_key, i) for i in range(spp)])

    def sample(self, camera: dict, resolution, seed: int, sample_idx: int):
        """One sample keyed by the step's key itself (a train step's
        sample), (n, 3) in lane order, differentiable in self.env and
        self.emit."""
        return self.trace(camera, resolution,
                          [rng.fold_in(rng.key(seed), sample_idx)])

    def trace(self, camera: dict, resolution, keys):
        cfg = self.cfg
        width, height = resolution
        n = width * height
        spp = len(keys)
        dev = self.scene.v0.device
        k0, k1 = rng.key_planes(keys, n, dev)
        lane = torch.arange(n, dtype=torch.int64, device=dev).repeat(spp)
        sample = torch.arange(spp, device=dev).repeat_interleave(n)
        pixel = torch.from_numpy(tile_order(width, height)).to(dev)
        u = rng.uniforms(k0, k1, lane, 0, 4)
        o, d = sh.primary_rays(camera, resolution, u, pixel[lane])
        p = Paths(self._qv(o), self._qv(d), k0, k1, lane, sample)
        self._primary(p)
        L = spp * n
        per_sample = torch.zeros(L, dtype=torch.int64, device=dev)
        per_sample += sample
        pooled = torch.zeros(L, dtype=torch.int64, device=dev)
        if not cfg["compact"]:
            for it in range(cfg["max_iters"]):
                self._bounce(p, it)
        elif cfg["wavefront_batch"] and spp > 1:
            plan, its, merged = merged_plan(cfg, n, spp)
            width_now, it0 = n, 0
            for w, count in plan:
                if w < width_now:
                    self._roulette(p, per_sample, spp, w, RR_STREAM + it0)
                    width_now = w
                for it in range(it0, it0 + count):
                    self._bounce(p, it)
                it0 += count
            if merged:
                w_b = -(-merged[0][0] // spp)
                if w_b < width_now:
                    self._roulette(p, per_sample, spp, w_b,
                                   RR_STREAM + cfg["max_iters"] + it0)
                    width_now = w_b
                width_now *= spp
            for w, count in merged:
                if w < width_now:
                    self._roulette(p, pooled, 1, w, RR_STREAM + it0)
                    width_now = w
                for it in range(it0, it0 + count):
                    self._bounce(p, it)
                it0 += count
        else:
            width_now, it0 = n, 0
            for w, count in schedule_groups(cfg, n):
                if w < width_now:
                    self._roulette(p, per_sample, spp, w, RR_STREAM + it0)
                    width_now = w
                for it in range(it0, it0 + count):
                    self._bounce(p, it)
                it0 += count
        # min(max(x, 0), hi): at a tie the gradient splits, as jnp.clip's
        c = p.color.stack()
        c = torch.minimum(torch.maximum(c, c.new_tensor(0.0)),
                          c.new_tensor(cfg["radiance_clamp"]))
        return c.reshape(spp, n, 3).sum(dim=0)

    def _primary(self, p: Paths):
        tmax = torch.full_like(p.t, self.max_t)
        t, tri, bu, bv = self._cast(p.o, p.d, tmax)
        miss = tri < 0
        sky = sh.env_bilinear(self.env, p.d, self.scene.env_theta)
        zero = torch.zeros_like(t)
        p.color = self._qv(where(miss, sky, V3(zero, zero, zero)))
        p.t, p.tri, p.u, p.v = self._q(t), tri, bu, bv
        p.alive = ~miss

    def _roulette(self, p: Paths, group, n_groups: int, w: int,
                  stream: int):
        """Keep, in each group, the w alive lanes with the smallest draw of
        `stream`; weight them A / w where A > w lanes were alive."""
        u = rng.uniforms(p.k0, p.k1, p.lane, stream, 1)[0]
        key = torch.where(p.alive, u, torch.full_like(u, 2.0)).double()
        order = torch.sort(group.double() * 4.0 + key, stable=True).indices
        g_sorted = group[order]
        start = torch.searchsorted(g_sorted, torch.arange(
            n_groups, device=g_sorted.device))
        rank = torch.empty_like(order)
        rank[order] = torch.arange(order.numel(), device=order.device) \
            - start[g_sorted]
        n_alive = torch.zeros(n_groups, dtype=torch.int64,
                              device=u.device).index_add_(
            0, group, p.alive.long())
        scale = torch.where(n_alive > w, n_alive.to(torch.float32) / float(w),
                            torch.ones(n_groups, device=u.device))[group]
        keep = p.alive & (rank < w)
        p.alive = keep
        p.thr = self._qv(where(keep, p.thr * scale, p.thr))

    def _bounce(self, p: Paths, it: int):
        cfg = self.cfg
        s = self.scene
        idx = torch.nonzero(p.alive).squeeze(1)
        if idx.numel() == 0:
            return
        u = rng.uniforms(p.k0[idx], p.k1[idx], p.lane[idx], 1 + it, 11)
        o = V3(*(c[idx] for c in p.o))
        d = V3(*(c[idx] for c in p.d))
        thr = V3(*(c[idx] for c in p.thr))
        color = V3(*(c[idx] for c in p.color))
        t, bu, bv, tri = p.t[idx], p.u[idx], p.v[idx], p.tri[idx]
        row = s.attr[tri]
        col3 = lambda i: V3(row[:, i], row[:, i + 1], row[:, i + 2])
        w0 = 1.0 - bu - bv
        lerp = lambda i: col3(i) * w0 + col3(i + 3) * bu + col3(i + 6) * bv
        tex_u = row[:, 27] * w0 + row[:, 29] * bu + row[:, 31] * bv
        tex_v = row[:, 28] * w0 + row[:, 30] * bu + row[:, 32] * bv
        bary_n, bary_t, bary_bt = lerp(0), lerp(9), lerp(18)
        emitt = V3.of(self.emit[tri])
        ior, diel = row[:, 36], row[:, 37]
        maps = s.maps[tri]
        diffuse = self._fetch(maps[:, 0], tex_u, tex_v)
        emissive = self._fetch(maps[:, 1], tex_u, tex_v)
        tn = self._fetch(maps[:, 2], tex_u, tex_v)
        mr = self._fetch(maps[:, 3], tex_u, tex_v)
        metallic, roughness = mr.x, mr.y * mr.y
        macro_n = normalize(bary_t * ((tn.x - 0.5) * 2.0)
                            + bary_bt * ((tn.y - 0.5) * 2.0) + bary_n * tn.z)
        inside = dot(-d, bary_n) < 0.0
        n1 = torch.where(inside, ior, 1.0)
        n2 = torch.where(inside, 1.0, ior)
        macro_n = where(inside, -macro_n, macro_n)
        hit_p = o + d * t
        eps2 = cfg["epsilon"] * 2.0
        offset_out = hit_p + macro_n * eps2
        hit_emit = thr * emitt
        nee_lights = cfg["use_light_nee"]
        if nee_lights:
            cos_l = torch.abs(dot(bary_n, -d))
            pdf_hit = t * t / torch.clamp(cos_l * s.light_area, min=1e-12)
            hit_emit = hit_emit * sh.mis_weights(p.prev_pdf[idx], pdf_hit)[0]
        color = color + (thr * emissive * diffuse * cfg["emissive_scale"]
                         + hit_emit)
        incident = -d
        micro_n = sh.sample_ggx(macro_n, roughness, u[0], u[1])
        env = self.env
        env_dir, env_pdf, nee_l = sh.sample_env(s.bins, env, s.env_theta,
                                                u[2], u[3], u[4])
        if not cfg["nee_env_nearest"]:
            nee_l = sh.env_bilinear(env, env_dir, s.env_theta)
        cos_env = dot(macro_n, env_dir)
        fresnel = sh.schlick(incident, micro_n, n1, n2)
        specular = (fresnel * (1.0 - metallic) + metallic) > u[5]
        refractive = ~specular & (diel >= 0.0)
        spec_dir = sh.reflect(-incident, micro_n)
        spec_pdf = sh.gtr2_pdf(incident, macro_n, roughness, spec_dir)
        spec_bsdf = (sh.eval_specular(incident, macro_n, diffuse, metallic,
                                      roughness, spec_dir)
                     * (torch.clamp(dot(macro_n, spec_dir), 0.0, 1.0)
                        / torch.clamp(spec_pdf, min=1e-12)))
        spec_env = (sh.eval_specular(incident, macro_n, diffuse, metallic,
                                     roughness, env_dir)
                    * (torch.clamp(cos_env, 0.0, 1.0) / env_pdf))
        refr_dir = sh.refract(d, micro_n, n1 / n2)
        diff_dir = sh.sample_cosine(macro_n, u[6], u[7])
        diff_pdf = sh.lambert_pdf(macro_n, diff_dir)
        lambert = diffuse * sh.INV_PI
        diff_bsdf = lambert * (torch.clamp(dot(macro_n, diff_dir), 0.0, 1.0)
                               / torch.clamp(diff_pdf, min=1e-12))
        diff_env = lambert * (torch.clamp(cos_env, 0.0, 1.0) / env_pdf)
        new_dir = normalize(where(specular, spec_dir,
                                  where(refractive, refr_dir, diff_dir)))
        bsdf_pdf = torch.where(specular, spec_pdf,
                               torch.where(refractive, 1.0, diff_pdf))
        one = V3(*(torch.ones_like(u[0]),) * 3)
        zero = V3(*(torch.zeros_like(u[0]),) * 3)
        bsdf_thr = where(specular, spec_bsdf,
                         where(refractive, one, diff_bsdf))
        env_thr = where(specular, spec_env, where(refractive, zero, diff_env))
        new_origin = where(refractive, hit_p - macro_n * eps2, offset_out)
        beer = V3(*(torch.clamp(1.0 - (1.0 - c) * t * diel, min=0.0)
                    for c in diffuse))
        bsdf_thr = where(inside, beer, bsdf_thr)
        w_env, w_bsdf = sh.mis_weights(env_pdf, bsdf_pdf)
        lights = nee_lights and s.lights.numel() > 0
        if lights:
            light_thr, light_l, w_light, light_dir, light_t, lit = self._light(
                u, offset_out, macro_n, incident, diffuse, metallic,
                roughness, specular, diel, bsdf_pdf)

        # the scattered ray and, where wanted, the environment's shadow ray
        # and the light's
        shadow = (diel < 0.0) & (cos_env > 0.0)
        m = idx.numel()
        sidx = torch.nonzero(shadow).squeeze(1)
        ro = V3(*(torch.cat([a, b[sidx]]) for a, b in zip(new_origin,
                                                             offset_out)))
        rd = V3(*(torch.cat([a, b[sidx]]) for a, b in zip(new_dir,
                                                             env_dir)))
        tmax = torch.full((ro.x.shape[0],), self.max_t, device=u.device)
        if lights:
            lidx = torch.nonzero(lit).squeeze(1)
            ro = V3(*(torch.cat([a, b[lidx]]) for a, b in zip(ro,
                                                                offset_out)))
            rd = V3(*(torch.cat([a, b[lidx]]) for a, b in zip(rd,
                                                                light_dir)))
            tmax = torch.cat([tmax, light_t[lidx]])
        ht, htri, hu, hv = self._cast(ro, rd, tmax)
        open_ = torch.zeros(m, dtype=torch.bool, device=u.device)
        open_[sidx] = htri[m:m + sidx.numel()] < 0
        nee = thr * env_thr * nee_l * w_env
        color = color + where(shadow & open_, nee, zero)
        if lights:
            l_open = torch.zeros(m, dtype=torch.bool, device=u.device)
            l_open[lidx] = htri[m + sidx.numel():] < 0
            color = color + where(lit & l_open,
                                  thr * light_thr * light_l * w_light, zero)
        thr = thr * bsdf_thr
        miss = htri[:m] < 0
        esc_l = (sh.env_nearest(env, new_dir, s.env_theta)
                 if cfg["escape_env_nearest"]
                 else sh.env_bilinear(env, new_dir, s.env_theta))
        color = color + where(miss, thr * esc_l * w_bsdf, zero)
        bounces = p.bounces[idx] + (~refractive).to(torch.int32)

        for dst, src in ((p.o, new_origin), (p.d, new_dir), (p.thr, thr),
                         (p.color, color)):
            for a, b in zip(dst, src):
                a[idx] = self._q(b)
        p.t[idx] = self._q(ht[:m])
        p.tri[idx], p.u[idx], p.v[idx] = htri[:m], hu[:m], hv[:m]
        p.bounces[idx] = bounces
        p.alive[idx] = ~miss & (bounces < cfg["bounces"])
        if nee_lights:
            p.prev_pdf[idx] = torch.where(refractive, p.prev_pdf[idx],
                                          bsdf_pdf)

    def _light(self, u, origin: V3, n: V3, incident: V3, diffuse: V3,
               metallic, roughness, specular, diel, bsdf_pdf):
        """One area-light sample a lane: (the sampled lobe's throughput
        over the light's pdf, the light's emittance, the MIS weight, the
        direction to the point, the shadow segment's length, where it is
        wanted)."""
        s = self.scene
        pick = torch.clamp(torch.searchsorted(s.light_cdf, u[8]), 0,
                           s.lights.numel() - 1)
        tri = s.lights[pick]
        a, e1, e2 = V3.of(s.v0[tri]), V3.of(s.e1[tri]), V3.of(s.e2[tri])
        r = torch.sqrt(u[9])
        to = a + e1 * (1.0 - r) + e2 * (u[10] * r) - origin
        dist2 = dot(to, to)
        dist = torch.sqrt(dist2)
        wi = to * torch.reciprocal(torch.clamp(dist, min=1e-12))
        cos_light = torch.abs(dot(normalize(sh.cross(e1, e2)), -wi))
        pdf = dist2 / torch.clamp(cos_light * s.light_area, min=1e-12)
        cos_s = dot(n, wi)
        lobe = where(specular,
                     sh.eval_specular(incident, n, diffuse, metallic,
                                      roughness, wi),
                     diffuse * sh.INV_PI)
        return (lobe * (torch.clamp(cos_s, 0.0, 1.0) / pdf),
                V3.of(self.emit[tri]), sh.mis_weights(pdf, bsdf_pdf)[0],
                wi, dist * (1.0 - 1e-3), (diel < 0.0) & (cos_s > 0.0))
