"""Raw THINGS-EEG/MEG preprocessing (counterpart of
``eeg_image_decode_tpu/preprocess``): epoching and MVNN on the device,
the MEG split and the ``images_set`` assembly on the host."""

from eeg_image_decode_tpu_torch.preprocess.mvnn import (  # noqa: F401
    ledoit_wolf_cov,
    matrix_inverse_sqrt,
    mvnn_whiten,
)
from eeg_image_decode_tpu_torch.preprocess.epoching import (  # noqa: F401
    CHANNEL_ORDER,
    epoch_session,
    find_events,
)
