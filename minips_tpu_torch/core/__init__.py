from minips_tpu_torch.core.config import Config, TableConfig, TrainConfig  # noqa: F401
from minips_tpu_torch.core.engine import Engine, Info, MLTask  # noqa: F401
