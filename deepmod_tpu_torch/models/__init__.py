from .bilstm import (
    BiLSTMConfig,
    init_bilstm_params,
    bilstm_center_features,
    bilstm_logits,
    bilstm_probs,
    bilstm_predict,
    bilstm_logits_trainable,
    bilstm_loss,
    count_params,
    CLASS_WEIGHTS,
)
from .cluster_mlp import ClusterMLPConfig, init_cluster_params, cluster_forward
