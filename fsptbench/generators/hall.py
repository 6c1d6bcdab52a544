"""The dungeon's hall (kind `hall`): a barrel-vaulted hall seen from
inside, as one OBJ with texture coordinates.

Its cross-section is `width` wide, with walls `spring` high up to a
semicircular vault; it runs `length` along z, centred on the origin, the
floor at y = 0.  The shell (floor, walls, vault) is a grid of
`floor_segments` + 2 `wall_segments` + `vault_segments` around the
section by `length_segments` along it; each end wall is a grid of the
same columns by `end_rows`, whose edges are the shell's end rings (it
shares their vertices, so no crack opens between them).  The shell's
quads whose centres lie in the `opening` at the vault's crown ([half
width in x, centre z, half length in z]) are left out.  Every face is
wound to face the inside.

Every vertex is displaced along its normal by `relief.amplitude` times
relief.py's height at its texture coordinates, whose seeded grain leaves
no flat face for another prop's face to lie on.  Texture coordinates are metres over `relief.tile`, around
the section (scaled to a whole number of tiles, so the seam in the floor's
corner matches) and along z on the shell, x and y on the end walls.
"""

import numpy as np

from fsptbench.generators.relief import fields, obj_text


def _section(w, h, nf, nw, nv):
    """The closed section, counter-clockwise seen from +z from the floor's
    left corner: points (P, 2), inward normals (P, 2), arc length (P,)."""
    r = w / 2.0
    pts = [np.stack([np.linspace(-r, r, nf + 1)[:-1], np.zeros(nf)], 1),
           np.stack([np.full(nw, r), np.linspace(0.0, h, nw + 1)[:-1]], 1)]
    th = np.linspace(0.0, np.pi, nv + 1)[:-1]
    pts.append(np.stack([r * np.cos(th), h + r * np.sin(th)], 1))
    pts.append(np.stack([np.full(nw, -r), np.linspace(h, 0.0, nw + 1)[:-1]],
                        1))
    pts = np.concatenate(pts)
    nxt = np.roll(pts, -1, axis=0) - pts
    seg = nxt / np.linalg.norm(nxt, axis=1, keepdims=True)
    # a segment's inward normal is its direction turned left
    seg_n = np.stack([-seg[:, 1], seg[:, 0]], 1)
    n = seg_n + np.roll(seg_n, 1, axis=0)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    arc = np.concatenate([[0.0], np.cumsum(np.linalg.norm(nxt, axis=1))])
    return pts, n, arc


def make(params):
    w, h, length = params["width"], params["spring"], params["length"]
    nf, nw, nv = (params["floor_segments"], params["wall_segments"],
                  params["vault_segments"])
    nl, nk = params["length_segments"], params["end_rows"]
    if nf != 2 * nw + nv:
        raise ValueError("hall: floor_segments must equal 2 wall_segments "
                         "+ vault_segments (the end walls' columns)")
    rel = params["relief"]
    tile = rel["tile"]
    pts, nrm, arc = _section(w, h, nf, nw, nv)
    p = len(pts)
    z = np.linspace(-length / 2.0, length / 2.0, nl + 1)

    # ---- the shell: vertex (i, k) = k * p + i; texture column p closes
    # the seam
    sv = np.zeros((nl + 1, p, 3))
    sv[..., :2] = pts
    sv[..., 2] = z[:, None]
    sn = np.zeros((nl + 1, p, 3))
    sn[..., :2] = nrm
    tiles = max(1, round(arc[-1] / tile))
    su = arc / arc[-1] * tiles
    uv_shell = np.stack(np.broadcast_arrays(su[None, :], z[:, None] / tile),
                        -1)                                   # (nl+1, p+1, 2)
    verts = sv.reshape(-1, 3)
    normals = sn.reshape(-1, 3)
    vert_uv = uv_shell[:, :p].reshape(-1, 2)
    ox, oz, oh = params["opening"]
    i, k = np.meshgrid(np.arange(p), np.arange(nl), indexing="xy")
    mid = 0.25 * (sv[k, i] + sv[k, (i + 1) % p] + sv[k + 1, i]
                  + sv[k + 1, (i + 1) % p])
    keep = ~((np.abs(mid[..., 0]) < ox) & (np.abs(mid[..., 2] - oz) < oh)
             & (mid[..., 1] > h))
    i, k = i[keep], k[keep]
    a, b = k * p + i, (k + 1) * p + i
    c, d = (k + 1) * p + (i + 1) % p, k * p + (i + 1) % p
    ta, tb = k * (p + 1) + i, (k + 1) * (p + 1) + i
    tc, td = (k + 1) * (p + 1) + i + 1, k * (p + 1) + i + 1
    faces = [np.stack([a, b, c], 1), np.stack([a, c, d], 1)]
    face_uvs = [np.stack([ta, tb, tc], 1), np.stack([ta, tc, td], 1)]
    uvs = [uv_shell.reshape(-1, 2)]

    # ---- the end walls: column j runs from floor point j up to section
    # point (p - j) % p; rows 0 and nk are the shell's, columns 0 and nf
    # fold into the floor's corners
    j = np.arange(nf + 1)
    top = (p - j) % p
    for ring, sign in ((0, 1.0), (nl, -1.0)):
        ids = np.empty((nk + 1, nf + 1), np.int64)
        ids[0] = ring * p + j % p
        ids[nk] = ring * p + top
        ids[:, 0], ids[:, nf] = ring * p, ring * p + nf
        frac = np.arange(1, nk)[:, None] / nk
        inner = (pts[j[1:-1]] * (1.0 - frac[..., None])
                 + pts[top[1:-1]] * frac[..., None])      # (nk-1, nf-1, 2)
        new = np.concatenate([inner.reshape(-1, 2),
                              np.full(((nk - 1) * (nf - 1), 1), z[ring])], 1)
        ids[1:nk, 1:nf] = (len(verts)
                           + np.arange(len(new)).reshape(nk - 1, nf - 1))
        verts = np.concatenate([verts, new])
        normals = np.concatenate(
            [normals, np.tile([0.0, 0.0, sign], (len(new), 1))])
        vert_uv = np.concatenate([vert_uv, new[:, :2] / tile])
        # the wall's own texture grid, x and y over the tile
        at = np.zeros((nk + 1, nf + 1, 2))
        at[0] = pts[j % p]
        at[nk] = pts[top]
        at[1:nk, 1:nf] = inner
        at[1:nk, 0], at[1:nk, nf] = pts[0], pts[nf]
        t0 = sum(len(x) for x in uvs)
        uvs.append(at.reshape(-1, 2) / tile)
        r, q = np.meshgrid(np.arange(nk), np.arange(nf), indexing="ij")
        a, b = ids[r, q], ids[r, q + 1]
        c, d = ids[r + 1, q + 1], ids[r + 1, q]
        t = lambda rr, qq: t0 + rr * (nf + 1) + qq
        quads = [(a, b, c, t(r, q), t(r, q + 1), t(r + 1, q + 1)),
                 (a, c, d, t(r, q), t(r + 1, q + 1), t(r + 1, q))]
        for x, y, zz, tx, ty, tz in quads:
            tri = np.stack([x, y, zz], -1).reshape(-1, 3)
            tuv = np.stack([tx, ty, tz], -1).reshape(-1, 3)
            if sign < 0:
                tri, tuv = tri[:, ::-1], tuv[:, ::-1]
            whole = ((tri[:, 0] != tri[:, 1]) & (tri[:, 1] != tri[:, 2])
                     & (tri[:, 2] != tri[:, 0]))
            faces.append(tri[whole])
            face_uvs.append(tuv[whole])

    height = fields(rel["surface"], vert_uv[:, 0], vert_uv[:, 1],
                    rel["seed"])["height"]
    verts = verts + normals * (rel["amplitude"] * height)[:, None]
    return obj_text(verts, np.concatenate(faces), np.concatenate(uvs),
                    np.concatenate(face_uvs))
