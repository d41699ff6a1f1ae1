from tpurec_torch.data.recordio import TFRecordWriter, ShardedTFRecordWriter, read_tfrecords  # noqa: F401
from tpurec_torch.data.example_proto import (  # noqa: F401
    encode_example,
    decode_example,
    encode_sequence_example,
    decode_sequence_example,
)
