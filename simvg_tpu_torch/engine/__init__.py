from .eval import make_eval_step, normalize_images_on_device
from .evaluate import evaluate
from .metrics import detection_accuracy
from .train import make_train_step
from .train_state import create_optimizer, create_train_state, ema_update

__all__ = ["create_optimizer", "create_train_state", "detection_accuracy",
           "ema_update", "evaluate", "make_eval_step", "make_train_step",
           "normalize_images_on_device"]
