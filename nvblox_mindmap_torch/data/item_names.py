"""Dataset item names: the port's own copy of
``nvblox_mindmap_tpu/data/item_names.py`` (upstream
``mindmap/data_loading/item_names.py``)."""

NVBLOX_VERTEX_FEATURES_ITEM_NAME = "nvblox_vertex_features.zst"

POLICY_STATE_HISTORY_ITEM_NAME = "runtime_policy_state_history"
GT_POLICY_STATE_PRED_ITEM_NAME = "runtime_gt_policy_state_pred"
IS_KEYPOSE_ITEM_NAME = "runtime_is_keypose"

COMMON_RUNTIME_ITEMS = [
    POLICY_STATE_HISTORY_ITEM_NAME,
    GT_POLICY_STATE_PRED_ITEM_NAME,
    IS_KEYPOSE_ITEM_NAME,
]

MESH_ITEMS = [NVBLOX_VERTEX_FEATURES_ITEM_NAME]
