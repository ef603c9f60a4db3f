"""filter_mrc command-line settings.

A dataclass + hand-rolled argv parser mirroring the reference's
``Settings::ParseArgs`` (``bin/filter_mrc/settings.cpp``) for the flag
set exercised by the reference docs and test suite. Parameters are
stored in *physical* units at parse time and rescaled to voxels by the
CLI (like ``filter_mrc.cpp:215-380``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


class InputError(Exception):
    pass


# filter types
NONE = "none"
GAUSS = "gauss"
GGAUSS = "ggauss"
DOG = "dog"
DOGG = "dogg"
LOG_DOG = "log"
MEDIAN = "median"
DILATION = "dilation"
EROSION = "erosion"
OPENING = "opening"
CLOSING = "closing"
TOP_HAT_WHITE = "top_hat_white"
TOP_HAT_BLACK = "top_hat_black"
FIND_EXTREMA = "find_extrema"
LOCAL_FLUCTUATIONS = "fluct"
WATERSHED = "watershed"
LABEL_CONNECTED = "label_connected"
SURFACE_RIDGE = "surface_ridge"
SURFACE_EDGE = "surface_edge"
CURVE = "curve"
BLOB = "blob"
BLOB_NONMAX_SUPPRESSION = "blob_nms"
BLOB_NONMAX_SUPERVISED_MULTI = "blob_supervised_multi"
DRAW_SPHERES = "draw_spheres"
# experimental ops (reference handlers_unsupported.cpp)
DOGGXY = "doggxy"
DISTANCE_TO_POINTS = "distance_to_points"
DISTANCE_TO_VOXELS = "distance_to_voxels"
RANDOM_SPHERES = "random_spheres"
TEMPLATE_GAUSS = "template_gauss"
BLOB_RADIAL_INTENSITY = "blob_radial_intensity"


@dataclasses.dataclass
class Region:
    kind: str           # "rect" | "sphere"
    params: tuple       # rect: (x1,x2,y1,y2,z1,z2); sphere: (x0,y0,z0,r)
    value: float


@dataclasses.dataclass
class Settings:
    in_file_name: str = ""
    out_file_name: str = ""
    mask_file_name: str = ""
    use_mask_select: bool = False
    mask_select: int = 1
    voxel_width: float = -1.0
    voxel_width_divide_by_10: bool = False
    resize_with_binning: int = 0
    resize_with_binning_explicit: bool = False
    in_set_image_size: Tuple[int, int, int] = (0, 0, 0)

    filter_type: str = NONE
    width_a: List[float] = dataclasses.field(
        default_factory=lambda: [0.0, 0.0, 0.0])
    width_b: List[float] = dataclasses.field(
        default_factory=lambda: [0.0, 0.0, 0.0])
    log_width: List[float] = dataclasses.field(
        default_factory=lambda: [0.0, 0.0, 0.0])
    m_exp: float = 2.0
    n_exp: float = 2.0
    morphology_r: float = 0.0
    morphology_rmax: float = 0.0
    morphology_bmax: float = 1.0
    median_radius: float = 0.0
    delta_sigma_over_sigma: float = 0.02
    filter_truncate_ratio: float = -1.0
    filter_truncate_threshold: float = 0.03
    normalize_near_boundaries: bool = True

    template_background_radius: List[float] = dataclasses.field(
        default_factory=lambda: [0.0, 0.0, 0.0])
    template_background_exponent: float = 2.0

    # experimental ops
    out_distances_file_name: str = ""
    rand_crds_n: int = 0
    rand_crds_diameter: float = -1.0
    rand_crds_seed: int = 0
    blob_profiles_center_criteria: str = "center"
    blob_profiles_file_name_base: str = ""

    # extrema
    find_minima: bool = False
    find_maxima: bool = False
    find_minima_file_name: str = ""
    find_maxima_file_name: str = ""
    neighbor_connectivity: int = 3
    extrema_on_boundary: bool = True

    # intensity map / thresholds
    use_intensity_map: bool = False
    use_dual_thresholds: bool = False
    use_gauss_thresholds: bool = False
    use_rescale_multiply: bool = False
    out_rescale_multiply: float = 1.0
    out_rescale_offset: float = 0.0
    in_threshold_01_a: float = 0.0
    in_threshold_01_b: float = 0.0
    in_threshold_10_a: float = 0.0
    in_threshold_10_b: float = 0.0
    out_thresh_a_value: float = 0.0
    out_thresh_b_value: float = 1.0
    out_thresh2_use_clipping: bool = False
    out_thresh2_use_clipping_sigma: bool = False
    out_thresh_gauss_x0: float = 0.0
    out_thresh_gauss_sigma: float = 1.0
    invert_output: bool = False
    rescale_min_max_in: bool = False
    rescale_min_max_out: bool = False
    in_rescale_min: float = 0.0
    in_rescale_max: float = 1.0
    out_rescale_min: float = 0.0
    out_rescale_max: float = 1.0
    specify_masked_brightness: bool = True
    masked_voxel_brightness: float = 0.0

    # blobs
    blob_diameters: List[float] = dataclasses.field(default_factory=list)
    blob_width_multiplier: float = 1.0
    blob_aspect_ratio: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    blob_minima_file_name: str = ""
    blob_maxima_file_name: str = ""
    score_upper_bound: float = np.inf
    score_lower_bound: float = -np.inf
    score_bounds_are_ratios: bool = False
    sphere_diameters_lower_bound: float = -np.inf
    sphere_diameters_upper_bound: float = np.inf
    nonmax_min_radial_separation_ratio: float = 0.0
    nonmax_max_volume_overlap_small: float = np.inf
    nonmax_max_volume_overlap_large: float = np.inf
    in_crds_file_names: List[str] = dataclasses.field(default_factory=list)
    out_crds_file_name: str = ""
    auto_thresh_score: bool = False
    training_pos_fname: str = ""
    training_neg_fname: str = ""
    training_pos_crds: np.ndarray = None
    training_neg_crds: np.ndarray = None
    is_training_pos_in_voxels: bool = False
    is_training_neg_in_voxels: bool = False
    supervised_multi_fname: str = ""

    # sphere decals
    sphere_decals_diameter: float = -1.0
    sphere_decals_diameter_in_voxels: bool = False
    sphere_decals_foreground: float = 1.0
    sphere_decals_foreground_use_score: bool = True
    sphere_decals_background: float = 0.0
    sphere_decals_background_scale: float = 1.0
    sphere_decals_background_norm: bool = False
    sphere_decals_foreground_norm: bool = False
    sphere_decals_scale: float = 1.0
    sphere_decals_shell_thickness: float = 1.0
    sphere_decals_shell_thickness_is_ratio: bool = True
    sphere_decals_shell_thickness_min: float = 1.0
    user_set_thickness_manually: bool = False

    # watershed / connect
    watershed_threshold: float = np.inf
    user_set_watershed_threshold: bool = False
    watershed_show_boundaries: bool = True
    # extension (not in the reference): keep the watershed on device
    # via label propagation instead of the host Meyer flood
    watershed_on_device: bool = False
    watershed_boundary_label: float = 0.0
    watershed_markers_filename: str = ""
    clusters_begin_at_maxima: bool = False
    cluster_connected_voxels: bool = False
    connect_threshold_saliency: float = np.inf
    connect_threshold_vector_saliency: float = float(np.cos(np.pi * 15 / 180))
    connect_threshold_vector_neighbor: float = float(np.cos(np.pi * 15 / 180))
    connect_threshold_tensor_saliency: float = float(np.cos(np.pi * 15 / 180))
    connect_threshold_tensor_neighbor: float = float(np.cos(np.pi * 15 / 180))
    select_cluster: int = 0
    must_link_filename: str = ""
    must_link_constraints: list = dataclasses.field(default_factory=list)
    must_link_directions: list = dataclasses.field(default_factory=list)
    is_must_link_in_voxels: bool = False
    undefined_voxel_brightness: float = -1.0
    undefined_voxels_are_max: bool = True

    # tv / membrane
    ridges_are_maxima: bool = False
    hessian_score_threshold: float = 0.05
    hessian_score_threshold_is_a_fraction: bool = True
    tv_sigma: float = 0.0
    tv_exponent: int = 4
    tv_truncate_ratio: float = float(np.sqrt(2.0))
    out_normals_fname: str = ""
    surface_normal_curve_ds: float = 0.2
    surface_find_ridge: bool = True
    max_distance_to_feature: float = 1.3
    save_intermediate_fname_base: str = ""
    load_intermediate_fname_base: str = ""
    # extensions: sharded phase checkpoints (io/checkpoint)
    save_progress_sharded: str = ""
    load_progress_sharded: str = ""
    # extension: shard the dense voxel stages over a (z, y) device
    # mesh.  0 = single-device (default), -1 = all visible devices,
    # N > 0 = first N devices.
    mesh_devices: int = 0

    mask_regions: List[Region] = dataclasses.field(default_factory=list)
    is_mask_crds_in_voxels: bool = False

    # set by filter_mrc.run
    image_size_orig: Tuple[int, int, int] = (0, 0, 0)
    cellA_orig: Tuple[float, float, float] = (0.0, 0.0, 0.0)


def parse_args(argv: List[str]) -> Settings:
    s = Settings()
    args = list(argv)
    i = 0

    def need(n, msg):
        if i + n >= len(args):
            raise InputError(f"Error: The {args[i]} argument {msg}")

    def f(k):
        return float(args[i + k])

    while i < len(args):
        a = args[i]
        n = 0  # extra args consumed
        if a in ("-in", "-i"):
            need(1, "must be followed by a file name"); s.in_file_name = args[i + 1]; n = 1
        elif a in ("-out", "-o"):
            need(1, "must be followed by a file name"); s.out_file_name = args[i + 1]; n = 1
        elif a == "-mask":
            need(1, "must be followed by a file name"); s.mask_file_name = args[i + 1]; n = 1
        elif a == "-mask-select":
            need(1, "needs 1 arg"); s.use_mask_select = True; s.mask_select = int(args[i + 1]); n = 1
        elif a in ("-mask-rect", "-mask-rectangle"):
            need(6, "needs 6 args")
            s.mask_regions.append(Region("rect", tuple(f(k) for k in range(1, 7)), 1.0)); n = 6
        elif a in ("-mask-rect-subtract", "-mask-rectangle-subtract"):
            need(6, "needs 6 args")
            s.mask_regions.append(Region("rect", tuple(f(k) for k in range(1, 7)), -1.0)); n = 6
        elif a == "-mask-sphere":
            need(4, "needs 4 args")
            s.mask_regions.append(Region("sphere", tuple(f(k) for k in range(1, 5)), 1.0)); n = 4
        elif a == "-mask-sphere-subtract":
            need(4, "needs 4 args")
            s.mask_regions.append(Region("sphere", tuple(f(k) for k in range(1, 5)), -1.0)); n = 4
        elif a == "-mask-rect-units-voxels":
            s.is_mask_crds_in_voxels = True
        elif a == "-mask-out":
            need(1, "needs 1 arg"); s.specify_masked_brightness = True
            s.masked_voxel_brightness = f(1); n = 1
        elif a == "-w":
            need(1, "must be followed by voxel width"); s.voxel_width = f(1); n = 1
        elif a in ("-a2nm", "-ang-to-nm"):
            s.voxel_width_divide_by_10 = True
        elif a == "-bin":
            need(1, "needs a positive integer")
            s.resize_with_binning = int(args[i + 1]); s.resize_with_binning_explicit = True
            if s.resize_with_binning < 1:
                raise InputError("-bin must be a positive integer")
            n = 1
        elif a == "-image-size":
            need(3, "needs 3 args")
            s.in_set_image_size = tuple(int(args[i + k]) for k in (1, 2, 3)); n = 3
        elif a in ("-gauss", "-ggauss"):
            need(1, "needs the Gaussian width")
            s.width_a = [f(1)] * 3; s.width_b = [-1.0] * 3
            s.filter_type = GGAUSS if a == "-ggauss" else GAUSS; n = 1
        elif a in ("-gauss-aniso", "-ggauss-aniso"):
            need(3, "needs 3 args")
            s.width_a = [f(1), f(2), f(3)]; s.width_b = [-1.0] * 3
            s.filter_type = GGAUSS if a == "-ggauss-aniso" else GAUSS; n = 3
        elif a in ("-dog", "-dogg"):
            need(2, "needs 2 positive numbers")
            s.width_a = [f(1)] * 3; s.width_b = [f(2)] * 3
            s.filter_type = DOGG if a == "-dogg" else DOG; n = 2
        elif a in ("-dog-aniso", "-dogg-aniso"):
            need(6, "needs 6 args")
            s.width_a = [f(1), f(2), f(3)]; s.width_b = [f(4), f(5), f(6)]
            s.filter_type = DOGG if a == "-dogg-aniso" else DOG; n = 6
        elif a == "-log-aniso":
            need(3, "needs 3 positive numbers")
            s.log_width = [f(1), f(2), f(3)]
            s.m_exp = 2.0; s.n_exp = 2.0
            s.filter_type = LOG_DOG; n = 3
        elif a in ("-log", "-log-d", "-log-r"):
            need(1, "needs 1 arg")
            w = f(1)
            if a == "-log-d":
                w = w / (2.0 * np.sqrt(3.0))
            elif a == "-log-r":
                w = w / np.sqrt(3.0)
            s.log_width = [w] * 3; s.filter_type = LOG_DOG; n = 1
        elif a == "-median":
            need(1, "needs 1 arg"); s.median_radius = f(1); s.filter_type = MEDIAN; n = 1
        elif a in ("-dilation", "-dilate"):
            need(1, "needs 1 arg"); s.morphology_r = f(1); s.filter_type = DILATION; n = 1
        elif a in ("-erosion", "-erode"):
            need(1, "needs 1 arg"); s.morphology_r = f(1); s.filter_type = EROSION; n = 1
        elif a in ("-opening", "-open"):
            need(1, "needs 1 arg"); s.morphology_r = f(1); s.filter_type = OPENING; n = 1
        elif a in ("-closing", "-close"):
            need(1, "needs 1 arg"); s.morphology_r = f(1); s.filter_type = CLOSING; n = 1
        elif a == "-top-hat-white":
            need(1, "needs 1 arg"); s.morphology_r = f(1); s.filter_type = TOP_HAT_WHITE; n = 1
        elif a == "-top-hat-black":
            need(1, "needs 1 arg"); s.morphology_r = f(1); s.filter_type = TOP_HAT_BLACK; n = 1
        elif a == "-truncate":
            need(1, "needs 1 arg")
            s.filter_truncate_ratio = f(1); s.filter_truncate_threshold = -1.0; n = 1
        elif a in ("-truncate-threshold", "-truncate-thresold"):
            need(1, "needs 1 arg")
            s.filter_truncate_threshold = f(1); s.filter_truncate_ratio = -1.0; n = 1
        elif a in ("-fluct", "-fluctuation", "-fluctuations"):
            need(1, "needs 1 arg")
            s.filter_type = LOCAL_FLUCTUATIONS
            s.masked_voxel_brightness = 0.0
            s.specify_masked_brightness = True
            s.template_background_radius = [f(1)] * 3; n = 1
        elif a in ("-fluct-aniso", "-fluctuation-aniso",
                   "-fluctuations-aniso"):
            need(3, "needs 3 args")
            s.filter_type = LOCAL_FLUCTUATIONS
            s.template_background_radius = [f(1), f(2), f(3)]; n = 3
        elif a == "-find-minima":
            need(1, "needs a file name")
            s.filter_type = FIND_EXTREMA; s.find_minima = True
            s.find_minima_file_name = args[i + 1]; n = 1
        elif a == "-find-maxima":
            need(1, "needs a file name")
            s.filter_type = FIND_EXTREMA; s.find_maxima = True
            s.find_maxima_file_name = args[i + 1]; n = 1
        elif a == "-neighbor-connectivity":
            need(1, "needs 1 arg"); s.neighbor_connectivity = int(args[i + 1]); n = 1
        elif a in ("-minima-threshold", "-min-threshold", "-score-upper-bound"):
            need(1, "needs 1 arg")
            s.score_upper_bound = f(1); s.score_bounds_are_ratios = False; n = 1
        elif a in ("-maxima-threshold", "-max-threshold", "-score-lower-bound"):
            need(1, "needs 1 arg")
            s.score_lower_bound = f(1); s.score_bounds_are_ratios = False; n = 1
        elif a in ("-minima-ratio", "-score-lower-bound-ratio"):
            need(1, "needs 1 arg")
            s.score_upper_bound = f(1); s.score_bounds_are_ratios = True; n = 1
        elif a in ("-maxima-ratio", "-score-upper-bound-ratio"):
            need(1, "needs 1 arg")
            s.score_lower_bound = f(1); s.score_bounds_are_ratios = True; n = 1
        elif a in ("-blob", "-blobs", "-blob-d", "-blob-diameters", "-blob-s",
                   "-blob-sigma", "-blob-r", "-blob-radii", "-blobr"):
            need(5, "needs type, file, and 3 numbers")
            kind = args[i + 1]
            fname = args[i + 2]
            if kind in ("minima", "min"):
                s.blob_minima_file_name = fname
                s.blob_maxima_file_name = ""
                s.score_upper_bound = 0.0
            elif kind in ("maxima", "max"):
                s.blob_maxima_file_name = fname
                s.blob_minima_file_name = ""
                s.score_lower_bound = 0.0
            elif kind == "all":
                s.blob_minima_file_name = fname + ".minima.txt"
                s.blob_maxima_file_name = fname + ".maxima.txt"
                if s.score_lower_bound == 0.0:
                    s.score_lower_bound = -np.inf
                if s.score_upper_bound == 0.0:
                    s.score_upper_bound = np.inf
            else:
                raise InputError(
                    "-blob type must be minima, maxima, or all")
            wmin, wmax, g = f(3), f(4), f(5)
            if wmin <= 0 or wmax <= 0 or wmin >= wmax or g <= 1.0:
                raise InputError("-blob numeric arguments invalid")
            nlad = 1 + int(np.ceil(np.log(wmax / wmin) / np.log(g)))
            g = (wmax / wmin) ** (1.0 / nlad)
            mult = 1.0
            if a in ("-blob-s", "-blob-sigma"):
                mult = 2.0 * np.sqrt(3.0)
            elif a in ("-blob-r", "-blob-radii", "-blobr"):
                mult = 2.0
            diam = [wmin * mult]
            for _ in range(1, nlad):
                diam.append(diam[-1] * g)
            s.blob_diameters = diam
            s.filter_type = BLOB
            n = 5
        elif a == "-blob-aspect-ratio":
            need(3, "needs 3 args")
            s.blob_aspect_ratio = (f(1), f(2), f(3)); n = 3
        elif a in ("-blob-separation", "-radial-separation",
                   "-blob-r-separation", "-blobr-separation",
                   "-spheres-nonmax-separation-radius"):
            need(1, "needs 1 arg")
            s.nonmax_min_radial_separation_ratio = f(1); n = 1
        elif a in ("-max-volume-overlap", "-max-overlap",
                   "-spheres-nonmax-overlap"):
            need(1, "needs 1 arg")
            s.nonmax_max_volume_overlap_large = f(1)
            s.nonmax_min_radial_separation_ratio = 0.0; n = 1
        elif a in ("-max-volume-overlap-small", "-max-overlap-small",
                   "-spheres-nonmax-overlap-small"):
            need(1, "needs 1 arg")
            s.nonmax_max_volume_overlap_small = f(1)
            s.nonmax_min_radial_separation_ratio = 0.0; n = 1
        elif a in ("-discard-blobs", "-blob-nonmax", "-blobs-nonmax"):
            need(2, "needs 2 file names")
            s.in_crds_file_names = [args[i + 1]]
            s.out_crds_file_name = args[i + 2]
            s.filter_type = BLOB_NONMAX_SUPPRESSION; n = 2
        elif a == "-auto-thresh":
            need(1, "needs 1 arg")
            if args[i + 1] != "score":
                raise InputError("-auto-thresh must be followed by 'score'")
            s.auto_thresh_score = True; n = 1
        elif a == "-supervised":
            need(2, "needs 2 file names")
            s.training_pos_fname = args[i + 1]
            s.training_neg_fname = args[i + 2]; n = 2
        elif a == "-supervised-multi":
            need(1, "needs a file name")
            s.supervised_multi_fname = args[i + 1]
            s.filter_type = BLOB_NONMAX_SUPERVISED_MULTI; n = 1
        elif a in ("-draw-spheres", "-spheres"):
            need(1, "needs a file name")
            s.in_crds_file_names = [args[i + 1]]
            s.filter_type = DRAW_SPHERES; n = 1
        elif a == "-draw-hollow-spheres":
            need(1, "needs a file name")
            s.in_crds_file_names = [args[i + 1]]
            s.filter_type = DRAW_SPHERES
            if not s.user_set_thickness_manually:
                s.sphere_decals_shell_thickness = 0.05
                s.sphere_decals_shell_thickness_is_ratio = True
                s.sphere_decals_shell_thickness_min = 1.0
            n = 1
        elif a in ("-diameters", "-diameter", "-sphere-diameters",
                   "-sphere-diameter"):
            need(1, "needs 1 arg")
            s.sphere_decals_diameter = f(1)
            s.sphere_decals_diameter_in_voxels = False; n = 1
        elif a in ("-radii", "-radius", "-sphere-radii", "-sphere-radius"):
            need(1, "needs 1 arg")
            s.sphere_decals_diameter = f(1) * 2.0
            s.sphere_decals_diameter_in_voxels = False; n = 1
        elif a in ("-radii-voxels", "-sphere-radii-voxels",
                   "-radius-voxels", "-sphere-radius-voxels"):
            need(1, "needs 1 arg")
            s.sphere_decals_diameter = f(1) * 2.0
            s.sphere_decals_diameter_in_voxels = True; n = 1
        elif a in ("-diameter-voxels", "-diameters-voxels",
                   "-sphere-diameter-voxels", "-sphere-diameters-voxels"):
            need(1, "needs 1 arg")
            s.sphere_decals_diameter = f(1)
            s.sphere_decals_diameter_in_voxels = True; n = 1
        elif a in ("-foreground", "-spheres-foreground", "-sphere-foreground"):
            need(1, "needs 1 arg")
            s.sphere_decals_foreground_use_score = False
            s.sphere_decals_foreground = f(1); n = 1
        elif a in ("-background", "-spheres-background", "-sphere-background"):
            need(1, "needs 1 arg")
            s.sphere_decals_background_scale = 0.0
            s.sphere_decals_background = f(1); n = 1
        elif a in ("-background-scale", "-spheres-background-scale",
                   "-sphere-background-scale"):
            need(1, "needs 1 arg")
            s.sphere_decals_background_scale = f(1); n = 1
        elif a == "-background-auto":
            s.sphere_decals_background_norm = True
            s.sphere_decals_background_scale = 0.3
        elif a in ("-spheres-normalize", "-sphere-normalize"):
            s.sphere_decals_foreground_norm = True
        elif a in ("-spheres01", "-spheres-01", "-sphere01", "-sphere-01"):
            s.sphere_decals_foreground_norm = False
        elif a in ("-spheres-score", "-sphere-score"):
            s.sphere_decals_foreground_use_score = True
        elif a in ("-sphere-shell-ratio", "-spheres-shell-ratio",
                   "-shell-ratio"):
            need(1, "needs 1 arg")
            s.sphere_decals_shell_thickness_is_ratio = True
            s.sphere_decals_shell_thickness = f(1); n = 1
        elif a in ("-sphere-shell-thickness", "-spheres-shell-thickness",
                   "-sphere-shell-thicknesses", "-spheres-shell-thicknesses"):
            need(1, "needs 1 arg")
            s.sphere_decals_shell_thickness_is_ratio = False
            s.sphere_decals_shell_thickness = f(1)
            s.user_set_thickness_manually = True; n = 1
        elif a in ("-sphere-shell-thickness-min",
                   "-sphere-shell-thicknesses-min",
                   "-spheres-shell-thickness-min",
                   "-spheres-shell-thicknesses-min"):
            need(1, "needs 1 arg")
            s.sphere_decals_shell_thickness_min = f(1)
            s.user_set_thickness_manually = True; n = 1
        elif a in ("-spheres-scale", "-sphere-scale"):
            need(1, "needs 1 arg"); s.sphere_decals_scale = f(1); n = 1
        elif a == "-mesh":
            # extension: run the dense voxel stages sharded over a
            # (z, y) device mesh ("auto"/"all" = every visible device)
            need(1, 'expects 1 argument (a device count or "auto")')
            arg = args[i + 1]
            s.mesh_devices = (-1 if arg in ("auto", "all")
                              else int(arg))
            n = 1
        elif a == "-watershed-device":
            # extension: device-resident steepest-descent watershed
            # (segment.propagate), mesh-sharded when several devices
            # are visible; markers + Meyer boundary labels supported
            # (exact label parity wherever intensities are distinct)
            s.watershed_on_device = True; n = 0
        elif a == "-watershed":
            need(1, "must be followed by minima or maxima")
            s.filter_type = WATERSHED
            if args[i + 1] in ("min", "minima"):
                s.clusters_begin_at_maxima = False
                if not s.user_set_watershed_threshold:
                    s.watershed_threshold = np.inf
            elif args[i + 1] in ("max", "maxima"):
                s.clusters_begin_at_maxima = True
                if not s.user_set_watershed_threshold:
                    s.watershed_threshold = -np.inf
            else:
                raise InputError("-watershed must be followed by "
                                 "minima or maxima")
            n = 1
        elif a == "-watershed-threshold":
            need(1, "needs 1 arg")
            s.filter_type = WATERSHED
            s.user_set_watershed_threshold = True
            s.watershed_threshold = f(1); n = 1
        elif a == "-watershed-show-boundaries":
            s.filter_type = WATERSHED; s.watershed_show_boundaries = True
        elif a == "-watershed-hide-boundaries":
            s.filter_type = WATERSHED; s.watershed_show_boundaries = False
        elif a == "-watershed-boundary":
            need(1, "needs 1 arg")
            s.filter_type = WATERSHED; s.watershed_boundary_label = f(1); n = 1
        elif a == "-markers":
            need(1, "needs a file name")
            s.filter_type = WATERSHED
            s.watershed_markers_filename = args[i + 1]; n = 1
        elif a in ("-connect", "-connect-bright", "-connect-saliency"):
            need(1, "needs 1 arg")
            s.cluster_connected_voxels = True
            s.clusters_begin_at_maxima = True
            s.connect_threshold_saliency = f(1); n = 1
        elif a == "-connect-dark":
            need(1, "needs 1 arg")
            s.cluster_connected_voxels = True
            s.clusters_begin_at_maxima = False
            s.connect_threshold_saliency = f(1); n = 1
        elif a == "-connect-angle":
            need(1, "needs 1 arg")
            s.cluster_connected_voxels = True
            c = float(np.cos(f(1) * np.pi / 180.0))
            s.connect_threshold_vector_saliency = c
            s.connect_threshold_vector_neighbor = c
            s.connect_threshold_tensor_saliency = c
            s.connect_threshold_tensor_neighbor = c; n = 1
        elif a in ("-connect-vector-saliency", "-cvs"):
            need(1, "needs 1 arg")
            s.cluster_connected_voxels = True
            s.connect_threshold_vector_saliency = f(1); n = 1
        elif a in ("-connect-vector-neighbor", "-cvn"):
            need(1, "needs 1 arg")
            s.cluster_connected_voxels = True
            s.connect_threshold_vector_neighbor = f(1); n = 1
        elif a in ("-connect-tensor-saliency", "-cts"):
            need(1, "needs 1 arg")
            s.cluster_connected_voxels = True
            s.connect_threshold_tensor_saliency = f(1); n = 1
        elif a in ("-connect-tensor-neighbor", "-ctn"):
            need(1, "needs 1 arg")
            s.cluster_connected_voxels = True
            s.connect_threshold_tensor_neighbor = f(1); n = 1
        elif a == "-select-cluster":
            need(1, "needs 1 arg"); s.select_cluster = int(args[i + 1]); n = 1
        elif a == "-must-link":
            need(1, "needs a file name")
            s.cluster_connected_voxels = True
            s.must_link_filename = args[i + 1]; n = 1
        elif a in ("-membrane", "-surface-ridge", "-edge", "-surface-edge",
                   "-curve"):
            need(2, "needs type and width")
            if a in ("-membrane", "-surface-ridge"):
                s.filter_type = SURFACE_RIDGE
            elif a in ("-edge", "-surface-edge"):
                s.filter_type = SURFACE_EDGE
            else:
                s.filter_type = CURVE
            if args[i + 1] in ("min", "minima"):
                s.ridges_are_maxima = False
            elif args[i + 1] in ("max", "maxima"):
                s.ridges_are_maxima = True
            else:
                raise InputError(f"{a} type must be minima or maxima")
            thickness = f(2)
            if s.filter_type == SURFACE_EDGE:
                sigma = thickness
            else:
                sigma = thickness / np.sqrt(3.0)
            s.width_a = [sigma] * 3
            s.width_b = [0.0] * 3
            n = 2
        elif a == "-membrane-background":
            need(1, "needs 1 arg"); s.width_b = [f(1)] * 3; n = 1
        elif a == "-tv":
            if s.filter_type not in (SURFACE_RIDGE, SURFACE_EDGE, CURVE):
                raise InputError("-tv must come after -membrane/-edge/-curve")
            need(1, "needs 1 arg"); s.tv_sigma = f(1); n = 1
        elif a == "-tv-angle-exponent":
            need(1, "needs 1 arg"); s.tv_exponent = int(args[i + 1]); n = 1
        elif a == "-tv-truncate-ratio":
            need(1, "needs 1 arg"); s.tv_truncate_ratio = f(1); n = 1
        elif a in ("-tv-best", "-best-visible", "-best"):
            need(1, "needs 1 arg")
            s.hessian_score_threshold = f(1)
            s.hessian_score_threshold_is_a_fraction = True
            if not (0.0 <= s.hessian_score_threshold <= 1.0):
                raise InputError("-tv-best must be between 0 and 1")
            n = 1
        elif a == "-tv-threshold":
            need(1, "needs 1 arg")
            s.hessian_score_threshold = f(1)
            s.hessian_score_threshold_is_a_fraction = False; n = 1
        elif a in ("-normals-file", "-surface-normals-file"):
            need(1, "needs a file name"); s.out_normals_fname = args[i + 1]; n = 1
        elif a == "-save-progress":
            need(1, "needs a file name")
            s.save_intermediate_fname_base = args[i + 1]; n = 1
        elif a == "-load-progress":
            need(1, "needs a file name")
            s.load_intermediate_fname_base = args[i + 1]; n = 1
        elif a == "-save-progress-sharded":
            # extension: persist the TV phase state (vote tensor +
            # saliency + direction) as a sharded checkpoint directory
            # (io/checkpoint: each rank writes its own blocks)
            need(1, "needs a directory name")
            s.save_progress_sharded = args[i + 1]; n = 1
        elif a == "-load-progress-sharded":
            need(1, "needs a directory name")
            s.load_progress_sharded = args[i + 1]; n = 1
        elif a in ("-thresh", "-thresh-out"):
            need(1, "needs 1 number")
            s.use_intensity_map = True; s.use_dual_thresholds = False
            s.in_threshold_01_a = s.in_threshold_01_b = f(1); n = 1
        elif a in ("-thresh2", "-thresh2-out"):
            need(2, "needs 2 numbers")
            s.use_intensity_map = True; s.use_dual_thresholds = False
            s.in_threshold_01_a = f(1); s.in_threshold_01_b = f(2)
            s.out_thresh2_use_clipping = False; n = 2
        elif a in ("-clip", "-cl"):
            need(2, "needs 2 numbers")
            s.use_intensity_map = True; s.use_dual_thresholds = False
            s.in_threshold_01_a = f(1); s.in_threshold_01_b = f(2)
            s.out_thresh2_use_clipping = True
            s.out_thresh2_use_clipping_sigma = (a == "-cl"); n = 2
        elif a in ("-thresh4", "-thresh4-out"):
            need(4, "needs 4 numbers")
            s.use_intensity_map = True; s.use_dual_thresholds = True
            s.in_threshold_01_a = f(1); s.in_threshold_01_b = f(2)
            s.in_threshold_10_a = f(3); s.in_threshold_10_b = f(4)
            inc = (s.in_threshold_01_a <= s.in_threshold_01_b
                   <= s.in_threshold_10_a <= s.in_threshold_10_b)
            dec = (s.in_threshold_01_a >= s.in_threshold_01_b
                   >= s.in_threshold_10_a >= s.in_threshold_10_b)
            if not (inc or dec):
                raise InputError("-thresh4 numbers must be monotonic")
            n = 4
        elif a in ("-thresh-interval", "-thresh-interval-out"):
            need(2, "needs 2 numbers")
            s.use_intensity_map = True; s.use_dual_thresholds = True
            s.in_threshold_01_a = s.in_threshold_01_b = f(1)
            s.in_threshold_10_a = s.in_threshold_10_b = f(2); n = 2
        elif a in ("-thresh-gauss", "-thresh-gauss-out"):
            need(2, "needs 2 numbers")
            s.use_intensity_map = True; s.use_gauss_thresholds = True
            s.out_thresh_gauss_x0 = f(1); s.out_thresh_gauss_sigma = f(2); n = 2
        elif a in ("-invert", "-inv"):
            s.invert_output = True
        elif a == "-rescale":
            need(2, "needs 2 numbers")
            s.use_intensity_map = True; s.use_rescale_multiply = True
            s.out_rescale_multiply = f(1); s.out_rescale_offset = f(2); n = 2
        elif a == "-rescale-min-max":
            # reference form: -rescale-min-max outA outB (min->outA,
            # max->outB per doc_filter_mrc.md:1945; the reference's
            # parser swaps the two by mistake -- we follow the doc).
            # Bare form defaults to [0, 1].
            s.rescale_min_max_out = True
            consumed = 0
            try:
                s.out_rescale_min = f(1)
                s.out_rescale_max = f(2)
                consumed = 2
            except (InputError, IndexError, ValueError):
                s.out_rescale_min, s.out_rescale_max = 0.0, 1.0
            n = consumed
        elif a == "-rescale-min-max-in":
            s.rescale_min_max_in = True
        elif a == "-np":
            need(1, "needs 1 arg"); n = 1  # thread count: ignored (XLA)
        elif a == "-undefined-out":
            need(1, "needs 1 arg")
            if args[i + 1] == "max":
                s.undefined_voxels_are_max = True
            else:
                s.undefined_voxels_are_max = False
                s.undefined_voxel_brightness = f(1)
            n = 1
        elif a in ("-outf", "-out-force"):
            need(1, "needs a file name")
            s.out_file_name = args[i + 1]; n = 1
        elif a == "-normalize-filters":
            need(1, 'needs "yes" or "no"')
            if args[i + 1] == "yes":
                s.normalize_near_boundaries = True
            elif args[i + 1] == "no":
                s.normalize_near_boundaries = False
            else:
                raise InputError('-normalize-filters needs "yes" or "no"')
            n = 1
        elif a in ("-dilation-binary-soft", "-dilate-binary-soft",
                   "-erosion-binary-soft", "-erode-binary-soft"):
            need(3, "needs r rmax bmax")
            s.morphology_r = f(1)
            s.morphology_rmax = f(2)
            s.morphology_bmax = f(3)
            s.filter_type = (DILATION if a.startswith(("-dilat", "-dila"))
                             else EROSION)
            n = 3
        elif a in ("-dilation-gauss", "-dilate-gauss",
                   "-erosion-gauss", "-erode-gauss"):
            # Gaussian blur followed by a threshold at 1-erf(1) (dilate)
            # or erf(1) (erode): soft morphology
            # (settings.cpp:807-839)
            need(1, "needs the blur distance")
            s.filter_type = GAUSS
            s.width_a = [f(1)] * 3
            s.use_intensity_map = True
            if a in ("-dilation-gauss", "-dilate-gauss"):
                s.in_threshold_01_a = 0.1572992070502851
            else:
                s.in_threshold_01_a = 0.8427007929497149
            s.in_threshold_01_b = s.in_threshold_01_a
            n = 1
        elif a == "-fill":
            need(1, "needs a number")
            s.use_intensity_map = True
            s.use_rescale_multiply = True
            s.out_rescale_multiply = 0.0
            s.out_rescale_offset = f(1); n = 1
        elif a in ("-thresh-range", "-thresh-range-out"):
            need(2, "needs 2 numbers: outA outB")
            s.out_thresh_a_value = f(1)
            s.out_thresh_b_value = f(2); n = 2
        elif a in ("-no-rescale", "-norescale"):
            s.rescale_min_max_out = False
            s.in_threshold_01_a = 1.0
            s.in_threshold_01_b = 1.0
        elif a == "-dog-delta":
            need(1, "needs 1 positive number")
            s.delta_sigma_over_sigma = f(1); n = 1
        elif a in ("-exponents", "-gdog-exponents"):
            need(2, "needs 2 positive numbers")
            s.m_exp = f(1); s.n_exp = f(2)
            s.template_background_exponent = s.n_exp; n = 2
        elif a in ("-exponent", "-gauss-exponent"):
            need(1, "needs 1 positive number")
            s.m_exp = f(1); s.n_exp = s.m_exp
            s.template_background_exponent = s.n_exp; n = 1
        elif a in ("-spheres-nonmax-radii-range",
                   "-sphere-nonmax-radii-range"):
            need(2, "needs 2 numbers")
            s.sphere_diameters_lower_bound = f(1)
            s.sphere_diameters_upper_bound = f(2); n = 2
        elif a in ("-spheres-nonmax-score-range",
                   "-sphere-nonmax-score-range"):
            need(2, "needs 2 numbers")
            s.score_lower_bound = f(1)
            s.score_upper_bound = f(2)
            s.score_bounds_are_ratios = False; n = 2
        elif a == "-boundary-extrema":
            s.extrema_on_boundary = True
        elif a == "-ignore-boundary-extrema":
            s.extrema_on_boundary = False
        elif a in ("-surface", "-planar"):
            raise InputError(f"Error: The {a} argument has been renamed. "
                             'It is now called "-membrane".')
        elif a == "--membrane-normals-file":
            raise InputError("Error: This argument has been renamed. "
                             'It is now called "-normals-file".')
        elif a == "-planar-tv":
            raise InputError("Error: This argument has been renamed. "
                             'It is now called "-tv".')
        elif a in ("-detection-background", "-membrane-background",
                   "-curve-background"):
            # pre-subtract a wide-Gaussian background before Hessian
            # analysis (settings.cpp:2802-2824; sets SURFACE_RIDGE
            # like the reference)
            need(1, "needs the background Gaussian width")
            s.filter_type = SURFACE_RIDGE
            s.width_b = [f(1)] * 3; n = 1
        elif a == "-detection-threshold":
            need(1, "needs 1 number")
            s.hessian_score_threshold = f(1)
            s.hessian_score_threshold_is_a_fraction = False; n = 1
        elif a in ("-max-distance-to-feature", "-max-distance-to-surface",
                   "-max-distance-to-membrane", "-max-distance-to-edge",
                   "-max-distance-to-curve"):
            need(1, "needs a positive number")
            if args[i + 1] in ("inf", "infinity", "disable"):
                s.max_distance_to_feature = 0.0
            else:
                # stored negative: physical units, flipped to voxels by
                # filter_mrc.run (filter_mrc.cpp:3012-3030)
                s.max_distance_to_feature = -f(1)
            n = 1
        elif a in ("-max-voxels-to-feature", "-max-voxels-to-surface",
                   "-max-voxels-to-membrane", "-max-voxels-to-edge",
                   "-max-voxels-to-curve"):
            need(1, "needs a positive number")
            if args[i + 1] in ("inf", "infinity", "disable"):
                s.max_distance_to_feature = 0.0
            else:
                s.max_distance_to_feature = f(1)
            n = 1
        elif a in ("-mask-crds-units", "-mask-coords-units",
                   "-mask-coordinates-units", "-mask-rect-units"):
            need(1, 'needs "voxels" or "distance"')
            if args[i + 1] == "voxels":
                s.is_mask_crds_in_voxels = True
            elif args[i + 1] in ("distance", "physical", "angstroms",
                                 "nm", "nanometers"):
                s.is_mask_crds_in_voxels = False
            else:
                raise InputError(f"{a} needs \"voxels\" or \"distance\"")
            n = 1
        elif a == "-doggxy":
            need(3, "needs 3 numbers: a_xy b_xy a_z")
            s.width_a[0] = s.width_a[1] = f(1)
            s.width_b[0] = s.width_b[1] = f(2)
            s.width_a[2] = f(3); s.width_b[2] = -1.0
            s.filter_type = DOGGXY; n = 3
        elif a == "-doggxy-aniso":
            need(5, "needs 5 numbers: a_x a_y b_x b_y a_z")
            s.width_a[0] = f(1); s.width_a[1] = f(2)
            s.width_b[0] = f(3); s.width_b[1] = f(4)
            s.width_a[2] = f(5); s.width_b[2] = -1.0
            s.filter_type = DOGGXY; n = 5
        elif a == "-distance-points":
            need(1, "needs a file name")
            s.filter_type = DISTANCE_TO_POINTS
            s.in_crds_file_names.append(args[i + 1]); n = 1
        elif a == "-distance-to-voxels":
            need(4, "needs InFile OutFile SelectMin SelectMax")
            s.filter_type = DISTANCE_TO_VOXELS
            s.in_crds_file_names.append(args[i + 1])
            s.out_distances_file_name = args[i + 2]
            s.out_thresh_a_value = f(3); s.out_thresh_b_value = f(4); n = 4
        elif a == "-random-spheres":
            need(6, "needs FILE Npoints diameter SelectMin SelectMax seed")
            s.filter_type = RANDOM_SPHERES
            s.out_crds_file_name = args[i + 1]
            s.rand_crds_n = int(args[i + 2])
            s.rand_crds_diameter = f(3)
            s.out_thresh_a_value = f(4); s.out_thresh_b_value = f(5)
            s.rand_crds_seed = int(args[i + 6])
            if not (s.rand_crds_n > 0 and s.rand_crds_diameter > 0):
                raise InputError("-random-spheres: Npoints and diameter "
                                 "must be positive")
            n = 6
        elif a in ("-template-gauss", "-template-gaussian"):
            need(2, "needs template_radius background_radius")
            s.filter_type = TEMPLATE_GAUSS
            s.masked_voxel_brightness = 0.0
            s.specify_masked_brightness = True
            s.width_a = [f(1)] * 3
            s.template_background_radius = [f(2)] * 3; n = 2
        elif a == "-template-gauss-aniso":
            need(6, "needs a_x a_y a_z bg_x bg_y bg_z")
            s.filter_type = TEMPLATE_GAUSS
            s.masked_voxel_brightness = 0.0
            s.specify_masked_brightness = True
            s.width_a = [f(1), f(2), f(3)]
            s.template_background_radius = [f(4), f(5), f(6)]; n = 6
        elif a in ("-max-overlap-radial", "-spheres-nonmax-overlap-radial"):
            need(1, "needs 1 number")
            s.nonmax_min_radial_separation_ratio = 1.0 - f(1); n = 1
        elif a == "-bs":
            raise InputError(
                "Error: bootstrapping (-bs) is disabled in the reference "
                "(DISABLE_BOOTSTRAPPING) and not supported here.")
        elif a in ("-blob-intensity-vs-radius", "-blob-radial-intensity"):
            need(3, "needs CENTER_TYPE input_coords_file output_base")
            kind = args[i + 1]
            if kind in ("min", "minima"):
                s.blob_profiles_center_criteria = "min"
            elif kind in ("max", "maxima"):
                s.blob_profiles_center_criteria = "max"
            elif kind in ("center", "cen"):
                s.blob_profiles_center_criteria = "center"
            else:
                raise InputError("-blob-intensity-vs-radius CENTER_TYPE "
                                 "must be min, max, or center")
            s.in_crds_file_names.append(args[i + 2])
            s.blob_profiles_file_name_base = args[i + 3]
            s.filter_type = BLOB_RADIAL_INTENSITY; n = 3
        elif a == "-normalize-near-boundaries":
            s.normalize_near_boundaries = True
        elif a == "-no-normalize-near-boundaries":
            s.normalize_near_boundaries = False
        else:
            raise InputError(f"Error: Unrecognized argument: {a}")
        i += n + 1

    # post-parse fixups (settings.cpp:3535-3551)
    if s.filter_type == SURFACE_RIDGE:
        s.tv_sigma *= s.width_a[0]
    if s.cluster_connected_voxels and s.filter_type not in (
            SURFACE_RIDGE, SURFACE_EDGE, CURVE):
        s.filter_type = LABEL_CONNECTED

    # read coordinate files referenced by flags
    from visfd_tpu_torch.io.coords import read_coordinates, process_link_constraints
    if s.training_pos_fname:
        s.training_pos_crds, s.is_training_pos_in_voxels = \
            read_coordinates(s.training_pos_fname)
    if s.training_neg_fname:
        s.training_neg_crds, s.is_training_neg_in_voxels = \
            read_coordinates(s.training_neg_fname)
    if s.must_link_filename:
        (s.must_link_constraints, s.must_link_directions,
         s.is_must_link_in_voxels) = process_link_constraints(
            s.must_link_filename)
    return s
