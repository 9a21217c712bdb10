"""Classic Perlin noise + turbulence, vectorized (reference:
shaders/src/perlin.glsl, itself the public stegu/webgl-noise cnoise).

Evaluates per-point noise for the `noise` texture's marble pattern
(ray_gen.glsl:203-208).  All ops are elementwise VPU work.
"""

from __future__ import annotations

import jax.numpy as jnp


def _mod289(x):
    return x - jnp.floor(x * (1.0 / 289.0)) * 289.0


def _permute(x):
    return _mod289(((x * 34.0) + 10.0) * x)


def _taylor_inv_sqrt(r):
    return 1.79284291400159 - 0.85373472095314 * r


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def cnoise(p):
    """Classic Perlin noise.  p: [..., 3] → [...]."""
    pi0 = jnp.floor(p)
    pi1 = pi0 + 1.0
    pi0 = _mod289(pi0)
    pi1 = _mod289(pi1)
    pf0 = p - jnp.floor(p)
    pf1 = pf0 - 1.0

    ix = jnp.stack([pi0[..., 0], pi1[..., 0], pi0[..., 0], pi1[..., 0]], -1)
    iy = jnp.stack([pi0[..., 1], pi0[..., 1], pi1[..., 1], pi1[..., 1]], -1)
    iz0 = pi0[..., 2:3]
    iz1 = pi1[..., 2:3]

    ixy = _permute(_permute(ix) + iy)
    ixy0 = _permute(ixy + iz0)
    ixy1 = _permute(ixy + iz1)

    def grads(ixy_):
        gx = ixy_ * (1.0 / 7.0)
        gy = (jnp.floor(gx) * (1.0 / 7.0)) % 1.0 - 0.5
        gx = gx % 1.0
        gz = 0.5 - jnp.abs(gx) - jnp.abs(gy)
        sz = jnp.where(gz <= 0.0, 1.0, 0.0)  # step(gz, 0)
        gx = gx - sz * (jnp.where(gx >= 0.0, 1.0, 0.0) - 0.5)
        gy = gy - sz * (jnp.where(gy >= 0.0, 1.0, 0.0) - 0.5)
        return gx, gy, gz

    gx0, gy0, gz0 = grads(ixy0)
    gx1, gy1, gz1 = grads(ixy1)

    g = lambda gx, gy, gz, i: jnp.stack([gx[..., i], gy[..., i], gz[..., i]], -1)
    g000, g100, g010, g110 = (g(gx0, gy0, gz0, i) for i in range(4))
    g001, g101, g011, g111 = (g(gx1, gy1, gz1, i) for i in range(4))

    dot = lambda a, b: jnp.sum(a * b, axis=-1)
    norm0 = _taylor_inv_sqrt(
        jnp.stack([dot(g000, g000), dot(g010, g010), dot(g100, g100), dot(g110, g110)], -1)
    )
    norm1 = _taylor_inv_sqrt(
        jnp.stack([dot(g001, g001), dot(g011, g011), dot(g101, g101), dot(g111, g111)], -1)
    )
    g000 = g000 * norm0[..., 0:1]
    g010 = g010 * norm0[..., 1:2]
    g100 = g100 * norm0[..., 2:3]
    g110 = g110 * norm0[..., 3:4]
    g001 = g001 * norm1[..., 0:1]
    g011 = g011 * norm1[..., 1:2]
    g101 = g101 * norm1[..., 2:3]
    g111 = g111 * norm1[..., 3:4]

    x0, y0, z0 = pf0[..., 0], pf0[..., 1], pf0[..., 2]
    x1, y1, z1 = pf1[..., 0], pf1[..., 1], pf1[..., 2]
    v3 = lambda a, b, c: jnp.stack([a, b, c], -1)

    n000 = dot(g000, pf0)
    n010 = dot(g010, v3(x0, y1, z0))
    n100 = dot(g100, v3(x1, y0, z0))
    n110 = dot(g110, v3(x1, y1, z0))
    n001 = dot(g001, v3(x0, y0, z1))
    n011 = dot(g011, v3(x0, y1, z1))
    n101 = dot(g101, v3(x1, y0, z1))
    n111 = dot(g111, v3(x1, y1, z1))

    fx, fy, fz = (_fade(pf0)[..., i] for i in range(3))
    mix = lambda a, b, t: a + (b - a) * t
    nz00 = mix(n000, n001, fz)
    nz10 = mix(n100, n101, fz)
    nz01 = mix(n010, n011, fz)
    nz11 = mix(n110, n111, fz)
    ny0 = mix(nz00, nz01, fy)
    ny1 = mix(nz10, nz11, fy)
    return 2.2 * mix(ny0, ny1, fx)


def turbulence(p, depth: int = 7):
    """7-octave |sum of halving-weight cnoise| (perlin.glsl:147-159)."""
    accum = jnp.zeros(p.shape[:-1], p.dtype)
    weight = 1.0
    q = p
    for _ in range(depth):
        accum = accum + weight * cnoise(q)
        weight *= 0.5
        q = q * 2.0
    return jnp.abs(accum)


# ---- component-wise variant (the wavefront's V3 layout) ----
#
# cnoise/turbulence above operate on [..., 3] stacks; the wavefront keeps
# ray state as separate [R] components (ops/vec3.py).  These mirrors
# apply the SAME expression tree per element with scalar components, so
# they are bitwise-identical to the stacked versions (verified by
# test_perlin).

def cnoise_v3(px, py, pz):
    """Classic Perlin noise on separate component arrays."""
    fpx, fpy, fpz = jnp.floor(px), jnp.floor(py), jnp.floor(pz)
    x0i, y0i, z0i = _mod289(fpx), _mod289(fpy), _mod289(fpz)
    x1i, y1i, z1i = (_mod289(fpx + 1.0), _mod289(fpy + 1.0),
                     _mod289(fpz + 1.0))
    x0, y0, z0 = px - fpx, py - fpy, pz - fpz
    x1, y1, z1 = x0 - 1.0, y0 - 1.0, z0 - 1.0

    def grads(v):
        gx = v * (1.0 / 7.0)
        gy = (jnp.floor(gx) * (1.0 / 7.0)) % 1.0 - 0.5
        gx = gx % 1.0
        gz = 0.5 - jnp.abs(gx) - jnp.abs(gy)
        sz = jnp.where(gz <= 0.0, 1.0, 0.0)
        gx = gx - sz * (jnp.where(gx >= 0.0, 1.0, 0.0) - 0.5)
        gy = gy - sz * (jnp.where(gy >= 0.0, 1.0, 0.0) - 0.5)
        return gx, gy, gz

    # corner order matches cnoise's lanes: (x0,y0) (x1,y0) (x0,y1) (x1,y1)
    corners = [(x0i, y0i), (x1i, y0i), (x0i, y1i), (x1i, y1i)]
    n = {}
    for idx, (cx, cy) in enumerate(corners):
        ixy = _permute(_permute(cx) + cy)
        for zi, (czi, cz, tag) in enumerate(
                [(z0i, z0, "0"), (z1i, z1, "1")]):
            gx, gy, gz = grads(_permute(ixy + czi))
            norm = _taylor_inv_sqrt(gx * gx + gy * gy + gz * gz)
            gx, gy, gz = gx * norm, gy * norm, gz * norm
            xx = x1 if idx in (1, 3) else x0
            yy = y1 if idx in (2, 3) else y0
            key = ("1" if idx in (1, 3) else "0") + \
                  ("1" if idx in (2, 3) else "0") + tag
            n[key] = gx * xx + gy * yy + gz * cz

    fx, fy, fz = _fade(x0), _fade(y0), _fade(z0)
    mix = lambda a, b, t: a + (b - a) * t
    nz00 = mix(n["000"], n["001"], fz)
    nz10 = mix(n["100"], n["101"], fz)
    nz01 = mix(n["010"], n["011"], fz)
    nz11 = mix(n["110"], n["111"], fz)
    ny0 = mix(nz00, nz01, fy)
    ny1 = mix(nz10, nz11, fy)
    return 2.2 * mix(ny0, ny1, fx)


def turbulence_v3(px, py, pz, depth: int = 7):
    """Component-wise turbulence (perlin.glsl:147-159)."""
    accum = jnp.zeros_like(px)
    weight = 1.0
    for _ in range(depth):
        accum = accum + weight * cnoise_v3(px, py, pz)
        weight *= 0.5
        px, py, pz = px * 2.0, py * 2.0, pz * 2.0
    return jnp.abs(accum)
