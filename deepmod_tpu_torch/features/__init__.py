from .builder import (
    build_feature_matrix,
    extract_windows,
    map_predictions_to_base_map,
    FeatureBuildError,
)
