"""box: the axis-aligned box from `lo` to `hi`, 2 triangles a face (12),
each face's normal outward."""

import numpy as np


def build(spec: dict):
    lo, hi = np.asarray(spec["lo"], np.float32), np.asarray(spec["hi"], np.float32)
    c = [np.array([hi[0] if i & 1 else lo[0], hi[1] if i & 2 else lo[1],
                   hi[2] if i & 4 else lo[2]], np.float32) for i in range(8)]
    faces = [((0, 4, 6, 2), (-1, 0, 0)), ((1, 3, 7, 5), (1, 0, 0)),
             ((0, 1, 5, 4), (0, -1, 0)), ((2, 6, 7, 3), (0, 1, 0)),
             ((0, 2, 3, 1), (0, 0, -1)), ((4, 5, 7, 6), (0, 0, 1))]
    tris, norms = [], []
    for (a, b, cc, d), nrm in faces:
        nv = np.asarray(nrm, np.float32)
        tris += [[c[a], c[b], c[cc]], [c[a], c[cc], c[d]]]
        norms += [[nv, nv, nv], [nv, nv, nv]]
    return np.asarray(tris, np.float32), np.asarray(norms, np.float32)
