from .descriptors import descriptor_distance_matrix, sample_descriptors
from .heatmap import bilinear_sample, refine_heatmap, remap_heatmap
from .lines import pair_geometry, pair_probe_mask, validate_edges
from .nms import nms_keypoints
from .pairs import candidate_geometry, probe_and_select, validate_candidates
from .sampling import (bilinear_f32, nearest_binary, nearest_binary_packed,
                       nearest_binary_packed_ref, pack_binary_mask,
                       remap_bilinear)

__all__ = [
    "nms_keypoints",
    "refine_heatmap",
    "remap_heatmap",
    "bilinear_sample",
    "bilinear_f32",
    "remap_bilinear",
    "pack_binary_mask",
    "nearest_binary",
    "nearest_binary_packed",
    "nearest_binary_packed_ref",
    "probe_and_select",
    "candidate_geometry",
    "validate_candidates",
    "pair_probe_mask",
    "validate_edges",
    "pair_geometry",
    "sample_descriptors",
    "descriptor_distance_matrix",
]
