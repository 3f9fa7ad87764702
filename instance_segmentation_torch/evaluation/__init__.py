from instance_segmentation_torch.evaluation.eval_loop import (
    detections_to_json, evaluate_model,
)
from instance_segmentation_torch.evaluation.cityscapes_ap import (
    InstancePrediction, compute_instance_ap,
)

__all__ = [
    "evaluate_model", "detections_to_json", "compute_instance_ap",
    "InstancePrediction",
]
