from instance_segmentation_torch.data.registry import (
    datasetBuildersMap, datasetClsNumMap, datasetEvalLabelMap,
    get_cls_num, get_dataloader, get_eval_labels,
)

__all__ = [
    "datasetBuildersMap", "datasetClsNumMap", "datasetEvalLabelMap",
    "get_cls_num", "get_dataloader", "get_eval_labels",
]
