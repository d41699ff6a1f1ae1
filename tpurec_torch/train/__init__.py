from tpurec_torch.train import losses  # noqa: F401
from tpurec_torch.train.trainer import Trainer, TrainState  # noqa: F401
