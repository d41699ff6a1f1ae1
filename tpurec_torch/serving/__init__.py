from tpurec_torch.serving.indexer import OfflineIndexer, exact_topk, recall_at_k  # noqa: F401
from tpurec_torch.serving.kvstore import DictKVStore, open_kv_store  # noqa: F401
