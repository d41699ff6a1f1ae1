from tpurec_torch.core.early_stop import EarlyStopper  # noqa: F401
from tpurec_torch.core.metrics import AUC, Mean, MetricBundle  # noqa: F401
