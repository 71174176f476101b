from repro_torch.train.loop import (TrainConfig, Trainer,  # noqa: F401
                                    make_train_step)
