"""Scale-out: the process mesh's collectives and the multi-process runtime
(counterpart of ``eeg_image_decode_tpu/parallel``)."""

from eeg_image_decode_tpu_torch.parallel.collectives import (  # noqa: F401
    data_parallel,
    gather_features,
    pmean_tree,
)
from eeg_image_decode_tpu_torch.parallel.multihost import (  # noqa: F401
    initialize as initialize_multihost,
    is_multiprocess,
    process_local_slice,
    replicate_global,
    shard_global_batch,
)
