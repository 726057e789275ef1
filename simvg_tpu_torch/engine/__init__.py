from .eval import make_eval_step, normalize_images_on_device
from .evaluate import evaluate
from .metrics import detection_accuracy

__all__ = ["detection_accuracy", "evaluate", "make_eval_step",
           "normalize_images_on_device"]
