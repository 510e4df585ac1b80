from repro_torch.training.optimizer import (OptConfig, adamw_init_schema,
                                            adamw_update)
from repro_torch.training.steps import make_train_step, make_eval_step

__all__ = ["OptConfig", "adamw_init_schema", "adamw_update",
           "make_train_step", "make_eval_step"]
