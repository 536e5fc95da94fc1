"""Edge-aware image comparison: the rule of the JAX package's
`utils/compare.assert_images_close`, with the same defaults.

Two float32 programs of the same formulas (another association, fused
multiply-adds, a matmul-form determinant) can decide an exactly-on-boundary
hit or shadow test the other way, which can only change pixels at
discontinuities of the image. So pixels off the image's edges must agree
within `tol`, up to a small budget of isolated outliers bounded in count,
magnitude and run length; edge pixels may differ, bounded in share and in
mean error.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ImageDiff:
    max_abs: int
    mean_abs: float
    n_diff: int  # pixels differing at all
    n_bad: int  # pixels differing by more than tol
    total: int
    tol: int
    n_off_edge: int = 0  # pixels beyond tol away from every edge
    off_edge_mag: int = 0  # the largest of those differences
    off_edge_run: int = 0  # longest row or column run of the large ones

    @property
    def frac_diff(self) -> float:
        return self.n_diff / max(self.total, 1)

    @property
    def frac_bad(self) -> float:
        return self.n_bad / max(self.total, 1)

    def __str__(self) -> str:
        return (f"max|d|={self.max_abs} mean|d|={self.mean_abs:.4f} "
                f"diff={self.n_diff}/{self.total} >{self.tol}: {self.n_bad} "
                f"({100 * self.frac_bad:.3f}%); off-edge {self.n_off_edge} "
                f"(max|d|={self.off_edge_mag}, run={self.off_edge_run})")


def diff_images(a: np.ndarray, b: np.ndarray, tol: int = 1) -> ImageDiff:
    """Whole-image difference statistics of two (H,W,C) integer images:
    largest and mean channel difference, pixels that differ at all and by
    more than `tol` (the off-edge fields stay 0)."""
    a = np.asarray(a, np.int32)
    b = np.asarray(b, np.int32)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    d = np.abs(a - b)
    per_pix = d.max(axis=-1)
    return ImageDiff(
        max_abs=int(d.max()) if d.size else 0,
        mean_abs=float(d.mean()) if d.size else 0.0,
        n_diff=int((per_pix > 0).sum()), n_bad=int((per_pix > tol).sum()),
        total=int(per_pix.size), tol=tol)


def edge_mask(img: np.ndarray, thresh: int = 8, dilate: int = 1) -> np.ndarray:
    """(H,W) bool: pixels where a channel differs by more than `thresh` from a
    4-neighbour, dilated `dilate` steps."""
    g = np.asarray(img, np.int32)
    m = np.zeros(g.shape[:2], bool)
    d = np.abs(g[1:] - g[:-1]).max(axis=-1) > thresh
    m[1:] |= d
    m[:-1] |= d
    d = np.abs(g[:, 1:] - g[:, :-1]).max(axis=-1) > thresh
    m[:, 1:] |= d
    m[:, :-1] |= d
    for _ in range(dilate):
        m2 = m.copy()
        m2[1:] |= m[:-1]
        m2[:-1] |= m[1:]
        m2[:, 1:] |= m[:, :-1]
        m2[:, :-1] |= m[:, 1:]
        m = m2
    return m


def max_outlier_run(mask: np.ndarray) -> int:
    """Longest run of consecutive True pixels along any row or column."""
    m = np.asarray(mask, bool)
    best = 0
    for arr in (m, m.T):
        run = np.zeros(arr.shape[1], np.int32)
        for row in arr:
            run = (run + 1) * row
            best = max(best, int(run.max()))
    return best


def assert_images_close(a, b, tol: int = 1, max_frac_diff: float = 0.05,
                        max_mean_abs: float = 1.0, edge_thresh: int = 8,
                        max_frac_off_edge: float = 5e-5,
                        max_off_edge_mag: int = 80, max_off_edge_run: int = 4,
                        run_mag_floor: int = 8, context: str = "") -> ImageDiff:
    """Raise AssertionError unless uint8 image `a` matches `b` up to
    floating-point boundary effects (see the module docstring); returns the
    difference statistics."""
    a = np.asarray(a, np.int32)
    b = np.asarray(b, np.int32)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    d = diff_images(a, b, tol=tol)
    per_pix = np.abs(a - b).max(axis=-1)
    off_edge_bad = (per_pix > tol) & ~edge_mask(b, thresh=edge_thresh)
    d = dataclasses.replace(
        d, n_off_edge=int(off_edge_bad.sum()),
        off_edge_mag=int(per_pix[off_edge_bad].max()) if off_edge_bad.any() else 0,
        # only outliers above run_mag_floor count toward a run: a displaced
        # silhouette in a mirror gives short strings of small differences
        off_edge_run=max_outlier_run(off_edge_bad
                                     & (per_pix > max(tol, run_mag_floor))))
    ok = (d.n_off_edge <= int(max_frac_off_edge * per_pix.size)
          and d.off_edge_mag <= max_off_edge_mag
          and d.off_edge_run <= max_off_edge_run
          and d.frac_bad <= max_frac_diff
          and d.mean_abs <= max_mean_abs)
    if not ok:
        raise AssertionError(
            f"images differ{' (' + context + ')' if context else ''}: {d}")
    return d
