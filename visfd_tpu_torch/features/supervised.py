"""Supervised blob-score threshold learning.

A copy of ``visfd_tpu/features/supervised.py`` (host numpy), importing
``BlobList`` and ``sort_blobs`` from the port.  Parity with ``feature_implementation.hpp:48-467``,
``visfd_utils.hpp:271-527``, and ``feature.hpp:988-1180``:

* ``find_spheres`` -- voxel lookup table mapping training coordinates
  to the highest-priority blob sphere containing them (blobs painted
  in increasing priority order, later wins);
* ``choose_threshold_1d`` -- optimal 1-D classifier threshold
  minimizing misclassifications, with the reference's median-index
  tie-break and +-infinity open-ended cases;
* ``choose_threshold_interval`` -- tries lower-bound-first and
  upper-bound-first orderings, keeps whichever misclassifies less;
* ``choose_blob_score_thresholds[_multi]`` and
  ``discard_blobs_by_score_supervised``.

All of this is tiny-list host-side work, like the reference.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from visfd_tpu_torch.features.blob import (
    SORT_DECREASING_MAGNITUDE, BlobList, sort_blobs)


def find_spheres(crds, sphere_centers, sphere_diameters):
    """For each query coordinate, the 1-based id of the sphere
    containing it (0 if none); spheres painted in increasing priority
    order so later (higher-priority) spheres win
    (``visfd_utils.hpp:271-360``)."""
    crds = np.asarray(crds)
    if len(crds) == 0:
        return np.zeros(0, np.int64)
    size = np.zeros(3, int)
    for d in range(3):
        size[d] = int(np.max(crds[:, d])) + 1 if len(crds) else 0
    table = np.zeros((size[2], size[1], size[0]), np.int64)
    for i, ((cx, cy, cz), diam) in enumerate(
            zip(sphere_centers, sphere_diameters)):
        ix, iy, iz = int(cx), int(cy), int(cz)
        r = max(int(np.ceil(diam / 2 - 0.5)), 0)
        rsqr = max(int(np.ceil((diam / 2) ** 2 - 0.5)), 0)
        for jz in range(-r, r + 1):
            for jy in range(-r, r + 1):
                for jx in range(-r, r + 1):
                    if jx * jx + jy * jy + jz * jz > rsqr:
                        continue
                    z, y, x = iz + jz, iy + jy, ix + jx
                    if (0 <= x < size[0] and 0 <= y < size[1]
                            and 0 <= z < size[2]):
                        table[z, y, x] = i + 1
    out = np.zeros(len(crds), np.int64)
    for i, (cx, cy, cz) in enumerate(crds):
        out[i] = table[int(cz), int(cy), int(cx)]
    return out


def choose_threshold_1d(scores, accepted, threshold_is_lower_bound=True):
    """Optimal threshold minimizing misclassification count
    (``visfd_utils.hpp:373-527``)."""
    scores = np.asarray(scores, np.float64)
    accepted = np.asarray(accepted, bool)
    n = len(scores)
    nn = int((~accepted).sum())
    sgn = 1.0 if threshold_is_lower_bound else -1.0

    idx = np.arange(n)
    if threshold_is_lower_bound:
        perm = np.lexsort((idx, scores))
    else:
        perm = np.lexsort((-idx, -scores))
    s = scores[perm]
    a = accepted[perm]

    # mistakes as the threshold passes each datum
    min_mistakes = nn
    mistakes = nn
    counts = [nn]
    for i in range(n):
        mistakes += 1 if a[i] else -1
        counts.append(mistakes)
        min_mistakes = min(min_mistakes, mistakes)
    indices = [i - 1 for i, c in enumerate(counts) if c == min_mistakes]
    i_thr = indices[len(indices) // 2]
    if i_thr == -1:
        return -sgn * np.inf
    if i_thr == n - 1:
        return sgn * np.inf
    thr = s[i_thr]
    if i_thr < n - 1:
        thr = 0.5 * (s[i_thr] + s[i_thr + 1])
    return float(thr)


def choose_threshold_interval(scores, accepted, report=None):
    """(lower, upper) bound pair minimizing misclassifications
    (``feature_implementation.hpp:136-275``)."""
    scores = np.asarray(scores, np.float64)
    accepted = np.asarray(accepted, bool)
    n = len(scores)

    def mistakes(lo, hi):
        inside = (scores >= lo) & (scores <= hi)
        return int((accepted != inside).sum())

    lo1 = choose_threshold_1d(scores, accepted, True)
    keep = scores >= lo1
    hi1 = choose_threshold_1d(scores[keep], accepted[keep], False)
    m1 = mistakes(lo1, hi1)

    hi2 = choose_threshold_1d(scores, accepted, False)
    keep2 = scores <= hi2
    lo2 = choose_threshold_1d(scores[keep2], accepted[keep2], True)
    m2 = mistakes(lo2, hi2)

    if m1 <= m2:
        lo, hi = lo1, hi1
    else:
        lo, hi = lo2, hi2
    if report:
        from visfd_tpu_torch.io.coords import fmt_g
        report.write(f"  threshold lower bound: {fmt_g(lo)}\n"
                     f"  threshold upper bound: {fmt_g(hi)}\n")
        inside = (scores >= lo) & (scores <= hi)
        fp = int((inside & ~accepted).sum())
        fn = int((~inside & accepted).sum())
        nn = int((~accepted).sum())
        np_ = int(accepted.sum())
        report.write(f"  number of false positives: {fp}"
                     f" (out of {nn} negatives)\n"
                     f"  number of false negatives: {fn}"
                     f" (out of {np_} positives)\n\n")
    return lo, hi


def _training_scores(blobs: BlobList, training_crds, training_accepted,
                     criteria=SORT_DECREASING_MAGNITUDE):
    """Map training points to containing-blob scores; points outside
    any blob are dropped (``feature_implementation.hpp:48-97`` +
    ``feature.hpp:643-697``)."""
    sorted_blobs = sort_blobs(blobs, criteria, ascending_order=True)
    ids = find_spheres(training_crds, sorted_blobs.crds,
                       sorted_blobs.diameters)
    keep = ids != 0
    scores = np.full(len(ids), -np.inf)
    scores[keep] = sorted_blobs.scores[ids[keep] - 1]
    return scores[keep], np.asarray(training_accepted, bool)[keep]


def choose_blob_score_thresholds(
    blobs: BlobList,
    training_pos, training_neg,
    criteria=SORT_DECREASING_MAGNITUDE,
    report=None,
):
    crds = np.concatenate([np.asarray(training_pos).reshape(-1, 3),
                           np.asarray(training_neg).reshape(-1, 3)])
    acc = np.concatenate([np.ones(len(training_pos), bool),
                          np.zeros(len(training_neg), bool)])
    scores, accepted = _training_scores(blobs, crds, acc, criteria)
    _complain_if_empty(accepted)
    return choose_threshold_interval(scores, accepted, report=report)


def choose_blob_score_thresholds_multi(
    blob_lists: Sequence[BlobList],
    training_pos_lists, training_neg_lists,
    criteria=SORT_DECREASING_MAGNITUDE,
    report=None,
):
    """Pooled training over multiple images
    (``feature_implementation.hpp:354-467``)."""
    all_scores, all_acc = [], []
    for blobs, pos, neg in zip(blob_lists, training_pos_lists,
                               training_neg_lists):
        crds = np.concatenate([np.asarray(pos).reshape(-1, 3),
                               np.asarray(neg).reshape(-1, 3)])
        acc = np.concatenate([np.ones(len(pos), bool),
                              np.zeros(len(neg), bool)])
        s, a = _training_scores(blobs, crds, acc, criteria)
        all_scores.append(s)
        all_acc.append(a)
    scores = np.concatenate(all_scores)
    accepted = np.concatenate(all_acc)
    _complain_if_empty(accepted)
    return choose_threshold_interval(scores, accepted, report=report)


def _complain_if_empty(accepted):
    if (~accepted).sum() == 0:
        raise ValueError("Empty list of negative training examples "
                         "(none lie inside any blob)")
    if accepted.sum() == 0:
        raise ValueError("Empty list of positive training examples "
                         "(none lie inside any blob)")


def discard_blobs_by_score_supervised(
    blobs: BlobList,
    training_pos, training_neg,
    criteria=SORT_DECREASING_MAGNITUDE,
    report=None,
) -> Tuple[BlobList, float, float]:
    lo, hi = choose_blob_score_thresholds(blobs, training_pos, training_neg,
                                          criteria, report=report)
    keep = (blobs.scores >= lo) & (blobs.scores <= hi)
    return blobs.take(keep), lo, hi
