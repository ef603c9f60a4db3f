"""Coordinate / blob-list text file I/O (IMOD-notation aware).

Parity with ``bin/filter_mrc/file_io.hpp``:

* ``parse_imod_line`` replicates ``IMODWords2Crds``
  (``file_io.hpp:86-214``): '#' comments; a leading "Pixel" word marks
  IMOD output; '(' / ')' stripping and comma splitting; for IMOD lines
  only the first 3 numbers are kept; when parentheses were present the
  first 3 coordinates are mapped ``x -> floor(x) - 1`` (IMOD is
  1-indexed voxels).  The "parenthesized" flag signals units of voxels.
* ``read_coordinates`` (``:362-398``), ``read_blob_coords_file``
  (``:411-498``), ``process_link_constraints`` (``:665-751``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from visfd_tpu_torch import native

AUTO = "auto"
SAME_DIRECTION = "same"
OPPOSITE_DIRECTION = "opposite"


def parse_imod_line(line: str, comment_char: str = "#"):
    """Returns (numbers, contains_parens)."""
    words = line.split()
    # strip comments
    cleaned = []
    stop = False
    for w in words:
        if comment_char and comment_char in w:
            w = w.split(comment_char)[0]
            if w:
                cleaned.append(w)
            stop = True
        else:
            cleaned.append(w)
        if stop:
            break
    words = cleaned
    is_imod = False
    contains_parens = False
    if words and words[0] == "Pixel":
        words = words[1:]
        is_imod = True
        contains_parens = True

    # strip parens/commas, split comma lists
    toks: List[str] = []
    for w in words:
        if w.startswith("("):
            contains_parens = True
            w = w[1:]
        if w.endswith(")"):
            contains_parens = True
            w = w[:-1]
        if w.endswith(","):
            w = w[:-1]
        if not w:
            continue
        toks.extend(t for t in w.split(",") if t != "")

    nums: List[float] = []
    for d, tok in enumerate(toks):
        if d >= 3 and is_imod:
            break  # IMOD lines: drop "= value" tail
        try:
            x = float(tok)
        except ValueError:
            if is_imod:
                break
            raise ValueError(f"File read error (invalid entry?): {line!r}")
        if (contains_parens or is_imod) and len(nums) < 3:
            x = float(np.floor(x)) - 1.0
        nums.append(x)
    return nums, contains_parens


def read_coordinates(path, comment_char: str = "#"):
    """Read x,y,z coordinate rows; returns (coords (N,3) float64,
    is_in_voxels). ``file_io.hpp:362-398``."""
    coords = []
    any_parens = False
    with open(path) as f:
        for line in f:
            nums, parens = parse_imod_line(line, comment_char)
            any_parens = any_parens or parens
            if len(nums) == 0:
                continue
            if len(nums) < 3:
                raise ValueError(f"Format error in {path}: {line!r}")
            coords.append(nums[:3])
    return np.asarray(coords, np.float64).reshape(-1, 3), any_parens


def read_blob_coords_file(
    path,
    diameter_override: float = -1.0,
    score_default: float = 0.0,
    diameter_factor: float = 1.0,
    comment_char: str = "#",
):
    """Read (x y z [diameter [score]]) rows; returns (crds (N,3),
    diameters (N,), scores (N,), is_in_voxels).
    ``file_io.hpp:411-498``."""
    crds, diams, scores = [], [], []
    has_parens = False
    with open(path) as f:
        for line in f:
            nums, parens = parse_imod_line(line, comment_char)
            has_parens = has_parens or parens
            if len(nums) == 0:
                continue
            if len(nums) not in (3, 4, 5):
                raise ValueError(
                    f"each line of {path} should contain 3-5 numbers")
            d = nums[3] if len(nums) > 3 else -1.0
            if d < 0:
                d = diameter_override
            if diameter_override >= 0:
                d = diameter_override
            else:
                d = d * diameter_factor
            s = nums[4] if len(nums) > 4 else score_default
            crds.append(nums[:3])
            diams.append(d)
            scores.append(s)
    return (np.asarray(crds, np.float64).reshape(-1, 3),
            np.asarray(diams, np.float64),
            np.asarray(scores, np.float64),
            has_parens)


# rows a chunk of write_blob_coords_file: its float64 rows and their text
# stay a few MiB whatever the list's length
CHUNK_ROWS = 1 << 16
# the most bytes a value's text takes ("-2.22507e-308") and its separator
_G6_BYTES = 14


def write_blob_coords_file(path, crds, diameters, scores):
    """Write blob rows 'x y z d score' like the reference handlers, each
    value as ``fmt_g`` writes it.  The rows are formatted in native code
    (``native.format_rows_g6``), ``CHUNK_ROWS`` at a time, through one
    buffer; the library loads at the first row."""
    crds = np.asarray(crds, np.float64).reshape(-1, 3)
    n = len(crds)
    rows = np.empty((min(n, CHUNK_ROWS), 5))
    text = np.empty(rows.size * _G6_BYTES, np.uint8)
    with open(path, "wb") as f:
        for lo in range(0, n, CHUNK_ROWS):
            hi = min(n, lo + CHUNK_ROWS)
            r = rows[:hi - lo]
            r[:, :3] = crds[lo:hi]
            r[:, 3] = diameters[lo:hi]
            r[:, 4] = scores[lo:hi]
            f.write(memoryview(text)[:native.format_rows_g6(r, text)])


def fmt_g(v: float) -> str:
    """C++ ostream default formatting (6 significant digits)."""
    return f"{float(v):.6g}"


def process_link_constraints(path):
    """Read blank-line-separated groups of (x y z [dir]) rows;
    returns (groups, directions, is_in_voxels)
    (``file_io.hpp:665-751``). dir > 0 -> SAME, < 0 -> OPPOSITE,
    omitted/0 -> AUTO."""
    groups: List[List[Tuple[float, float, float]]] = []
    dirs: List[List[str]] = []
    cur: List[Tuple[float, float, float]] = []
    cur_d: List[str] = []
    any_parens = False
    with open(path) as f:
        lines = f.readlines()
    for line in lines:
        nums, parens = parse_imod_line(line)
        any_parens = any_parens or parens
        if len(nums) == 0:
            if cur:
                groups.append(cur)
                dirs.append(cur_d)
            cur, cur_d = [], []
        elif len(nums) in (3, 4):
            cur.append(tuple(nums[:3]))
            if len(nums) == 4:
                cur_d.append(SAME_DIRECTION if nums[3] > 0
                             else (OPPOSITE_DIRECTION if nums[3] < 0
                                   else AUTO))
            else:
                cur_d.append(AUTO)
        else:
            raise ValueError(
                f"each line of {path} should contain 3, 4 or 0 numbers")
    if cur:
        groups.append(cur)
        dirs.append(cur_d)
    if not groups:
        raise ValueError(f"{path} contains no voxel coordinates")
    for g in groups:
        if len(g) < 2 or g[0] == g[1]:
            raise ValueError(
                "each must-link group needs >= 2 distinct voxels")
    return groups, dirs, any_parens
