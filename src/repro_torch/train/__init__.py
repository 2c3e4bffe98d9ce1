from .step import (TrainConfig, build_serve_step, build_train_step,
                   init_train_state, loss_and_grads, model_dtypes)
